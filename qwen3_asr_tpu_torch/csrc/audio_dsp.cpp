// The bit loops of the port's host audio decoders.
//
// FLAC (audio/flac.py), the counterpart of the FLAC routines of
// qwen3_asr_tpu/native/audio_dsp.cpp: Rice and raw residual decoding and
// the LPC/fixed prediction recurrence. The frame and subframe parsing
// stays in Python; a call takes the stream's bytes and an ABSOLUTE bit
// offset (MSB first within each byte) and returns the offset where it
// stopped, so the Python bit reader hands off and resumes around each call.
//
// MP3 (audio/mp3.py): every frame's side information, bit reservoir,
// scale factors and the Huffman decode of each granule's regions. MPEG
// audio Layer I and II (audio/mpa.py): the allocation, scale factors and
// sample codes of every frame. Vorbis (audio/vorbis.py): the scalar codebook decode and
// one packet's residue decode. Each has a plain Python version in its
// module that decodes to the same bits; every read is bounds-checked, and
// every loop is bounded by the sizes the caller allocated.
//
// Host code with a plain C interface, built by ops/_build.py build_host
// into qwen3_asr_tpu_torch/_build/ at first use and loaded with ctypes
// (audio/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>

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

// -- MP3 ----------------------------------------------------------------------
//
// The bit loops of every frame of a Layer III stream: side information,
// the bit reservoir, scale factors (MPEG-1 and LSF) and the Huffman decode
// of each granule's big_values and count1 regions (audio/mp3.py
// granules_plain is the plain version). Bits are MSB first; a read past
// the end of the reservoir gives zero bits.

enum {
    MP3_PART2_3, MP3_BIG_VALUES, MP3_GLOBAL_GAIN, MP3_SF_COMPRESS,
    MP3_BLOCK_TYPE, MP3_MIXED, MP3_TSEL0, MP3_TSEL1, MP3_TSEL2, MP3_SBG0,
    MP3_SBG1, MP3_SBG2, MP3_REGION1, MP3_REGION2, MP3_PREFLAG, MP3_SF_SCALE,
    MP3_COUNT1, MP3_INFO
};

struct Mp3Bits {
    const uint8_t* d;
    int64_t n_bits;
    int64_t pos;
    int bit() {
        const int b = pos < n_bits ? (d[pos >> 3] >> (7 - (pos & 7))) & 1 : 0;
        ++pos;
        return b;
    }
    int read(int n) {
        int v = 0;
        for (int i = 0; i < n; ++i) v = (v << 1) | bit();
        return v;
    }
};

static inline int mp3_leaf(Mp3Bits& r, const int32_t* tree, int64_t tree_len,
                           int root) {
    int64_t node = root;
    // A code is at most 19 bits; the bound also stops a corrupt tree.
    for (int depth = 0; depth < 32; ++depth) {
        const int64_t at = 2 * node + r.bit();
        if (at < 0 || at >= tree_len) return -1;
        const int32_t next = tree[at];
        if (next < 0) return -next - 1;
        node = next;
    }
    return -1;
}

static int mp3_huffman_granule(Mp3Bits& r, int64_t end, const int32_t* g,
                               const int32_t* tree, int64_t tree_len,
                               const int32_t* starts, const int32_t* linbits,
                               int32_t* o) {
    const int64_t big = g[MP3_BIG_VALUES] > 288 ? 288 : g[MP3_BIG_VALUES];
    const int64_t r1 = g[MP3_REGION1], r2 = g[MP3_REGION2];
    const int c1 = g[MP3_COUNT1];
    int64_t i = 0;
    while (i < 2 * big) {
        const int t = i < r1 ? g[MP3_TSEL0] : (i < r2 ? g[MP3_TSEL1]
                                                      : g[MP3_TSEL2]);
        if (t < 0 || t > 31) return -1;
        if (starts[t] < 0) { i += 2; continue; }
        const int v = mp3_leaf(r, tree, tree_len, starts[t]);
        if (v < 0) return -1;
        const int lb = linbits[t];
        const int xy[2] = {v >> 4, v & 15};
        for (int k = 0; k < 2; ++k) {
            int x = xy[k];
            if (lb && x == 15) x += r.read(lb);
            if (x && r.bit()) x = -x;
            o[i++] = x;
        }
    }
    while (i < 576 && r.pos < end) {
        const int v = mp3_leaf(r, tree, tree_len, starts[c1]);
        if (v < 0) return -1;
        int q[4] = {(v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1};
        for (int k = 0; k < 4; ++k)
            if (q[k] && r.bit()) q[k] = -1;
        if (r.pos > end) break;
        for (int k = 0; k < 4 && i + k < 576; ++k) o[i + k] = q[k];
        i += 4;
    }
    return 0;
}

static const int MP3_SLEN[16][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {3, 0}, {1, 1}, {1, 2}, {1, 3},
    {2, 1}, {2, 2}, {2, 3}, {3, 1}, {3, 2}, {3, 3}, {4, 2}, {4, 3}};
static const int MP3_NR_OF_SFB[6][3][4] = {
    {{6, 5, 5, 5}, {9, 9, 9, 9}, {6, 9, 9, 9}},
    {{6, 5, 7, 3}, {9, 9, 12, 6}, {6, 9, 12, 6}},
    {{11, 10, 0, 0}, {18, 18, 0, 0}, {15, 18, 0, 0}},
    {{7, 7, 7, 0}, {12, 12, 12, 0}, {6, 15, 12, 0}},
    {{6, 6, 6, 3}, {12, 9, 9, 6}, {6, 12, 9, 6}},
    {{8, 8, 5, 0}, {15, 12, 9, 0}, {6, 18, 9, 0}}};

static void mp3_region_starts(int32_t* g, const int32_t* sfb, int lsf,
                              int mpeg25, int switching, int r0c, int r1c) {
    if (switching) {
        g[MP3_REGION2] = 576;
        if (mpeg25)
            g[MP3_REGION1] = sfb[g[MP3_BLOCK_TYPE] == 2 && !g[MP3_MIXED] ? 6
                                                                       : 8];
        else if (!lsf || g[MP3_BLOCK_TYPE] == 2)
            g[MP3_REGION1] = 36;
        else
            g[MP3_REGION1] = 54;
    } else {
        g[MP3_REGION1] = sfb[r0c + 1 < 22 ? r0c + 1 : 22];
        g[MP3_REGION2] = sfb[r0c + r1c + 2 < 22 ? r0c + r1c + 2 : 22];
    }
}

// frames: [n_frames][5] = byte offset, CRC flag, mode, mode extension,
// size. sfb_long: the rate's 23 long band edges. Outputs, for
// G = n_frames * granules * channels rows in (frame, granule, channel)
// order: decoded[n_frames] (0 where the frame is not decoded), info[G][17]
// (MP3_* fields), sf_long[G][22], sf_short[G][13][3], ix[G][576]; rows of
// frames not decoded stay zero. Returns the number of frames decoded, -2
// on intensity stereo, -1 on corrupt side information or tables.
int64_t mp3_frames(const uint8_t* data, int64_t n_bytes,
                   const int64_t* frames, int64_t n_frames, int lsf,
                   int mpeg25, int nch, const int32_t* sfb_long,
                   const int32_t* tree, int64_t tree_len,
                   const int32_t* starts, const int32_t* linbits,
                   uint8_t* decoded, int32_t* info, int32_t* sf_long,
                   int32_t* sf_short, int32_t* ix) {
    const int ngr = lsf ? 1 : 2;
    const int si_size = lsf ? (nch == 1 ? 9 : 17) : (nch == 1 ? 17 : 32);
    std::vector<uint8_t> res;
    std::vector<int64_t> gstart(static_cast<size_t>(n_frames) * ngr * nch);
    std::vector<int> scfsi(static_cast<size_t>(n_frames) * nch);
    int64_t n_decoded = 0;
    for (int64_t f = 0; f < n_frames; ++f) {
        const int64_t* fr = frames + 5 * f;
        const int64_t pos = fr[0], size = fr[4];
        const int mode = static_cast<int>(fr[2]);
        const int mode_ext = static_cast<int>(fr[3]);
        decoded[f] = 0;
        const int64_t si = pos + 4 + 2 * fr[1];
        const int64_t main = si + si_size;
        if (pos < 0 || pos + size > n_bytes || main > pos + size) continue;
        if (mode == 1 && (mode_ext & 1)) return -2;
        Mp3Bits r{data, n_bytes * 8, si * 8};
        int md_begin;
        if (lsf) {
            md_begin = r.read(8);
            r.read(nch == 1 ? 1 : 2);
        } else {
            md_begin = r.read(9);
            r.read(nch == 1 ? 5 : 3);
            for (int ch = 0; ch < nch; ++ch) scfsi[f * nch + ch] = r.read(4);
        }
        for (int gr = 0; gr < ngr; ++gr) {
            for (int ch = 0; ch < nch; ++ch) {
                int32_t* g = info + MP3_INFO * ((f * ngr + gr) * nch + ch);
                for (int k = 0; k < MP3_INFO; ++k) g[k] = 0;
                g[MP3_PART2_3] = r.read(12);
                const int big = r.read(9);
                g[MP3_BIG_VALUES] = big > 288 ? 288 : big;
                g[MP3_GLOBAL_GAIN] = r.read(8);
                g[MP3_SF_COMPRESS] = r.read(lsf ? 9 : 4);
                if (r.read(1)) {
                    g[MP3_BLOCK_TYPE] = r.read(2);
                    g[MP3_MIXED] = r.read(1);
                    g[MP3_TSEL0] = r.read(5);
                    g[MP3_TSEL1] = r.read(5);
                    g[MP3_SBG0] = r.read(3);
                    g[MP3_SBG1] = r.read(3);
                    g[MP3_SBG2] = r.read(3);
                    if (g[MP3_BLOCK_TYPE] == 0) return -1;
                    mp3_region_starts(g, sfb_long, lsf, mpeg25, 1, 0, 0);
                } else {
                    g[MP3_TSEL0] = r.read(5);
                    g[MP3_TSEL1] = r.read(5);
                    g[MP3_TSEL2] = r.read(5);
                    const int r0c = r.read(4), r1c = r.read(3);
                    mp3_region_starts(g, sfb_long, lsf, mpeg25, 0, r0c, r1c);
                }
                if (!lsf) g[MP3_PREFLAG] = r.read(1);
                g[MP3_SF_SCALE] = r.read(1);
                g[MP3_COUNT1] = 32 + r.read(1);
            }
        }
        const int64_t begin = static_cast<int64_t>(res.size()) - md_begin;
        res.insert(res.end(), data + main, data + pos + size);
        if (begin < 0) continue;  // the reservoir reaches before the data
        decoded[f] = 1;
        ++n_decoded;
        int64_t bit = 8 * begin;
        for (int k = 0; k < ngr * nch; ++k) {
            gstart[f * ngr * nch + k] = bit;
            bit += info[MP3_INFO * (f * ngr * nch + k) + MP3_PART2_3];
        }
    }
    const uint8_t* rd = res.empty() ? nullptr : res.data();
    const int64_t res_bits = static_cast<int64_t>(res.size()) * 8;
    for (int64_t f = 0; f < n_frames; ++f) {
        if (!decoded[f]) continue;
        for (int gr = 0; gr < ngr; ++gr) {
            for (int ch = 0; ch < nch; ++ch) {
                const int64_t k = (f * ngr + gr) * nch + ch;
                int32_t* g = info + MP3_INFO * k;
                int32_t* sl = sf_long + 22 * k;
                int32_t* ss = sf_short + 39 * k;
                Mp3Bits r{rd, res_bits, gstart[k]};
                const int bt = g[MP3_BLOCK_TYPE], mixed = g[MP3_MIXED];
                if (!lsf) {
                    const int slen1 = MP3_SLEN[g[MP3_SF_COMPRESS]][0];
                    const int slen2 = MP3_SLEN[g[MP3_SF_COMPRESS]][1];
                    if (bt == 2) {
                        int first = 0;
                        if (mixed) {
                            for (int b = 0; b < 8; ++b) sl[b] = r.read(slen1);
                            first = 3;
                        }
                        for (int b = first; b < 12; ++b) {
                            const int n = b < 6 ? slen1 : slen2;
                            for (int w = 0; w < 3; ++w)
                                ss[3 * b + w] = r.read(n);
                        }
                    } else {
                        static const int lo[4] = {0, 6, 11, 16};
                        static const int hi[4] = {6, 11, 16, 21};
                        const int s = scfsi[f * nch + ch];
                        for (int band = 0; band < 4; ++band) {
                            const int n = band < 2 ? slen1 : slen2;
                            if (gr == 1 && (s & (8 >> band))) {
                                const int32_t* prev = sf_long + 22 * (k - nch);
                                for (int b = lo[band]; b < hi[band]; ++b)
                                    sl[b] = prev[b];
                            } else {
                                for (int b = lo[band]; b < hi[band]; ++b)
                                    sl[b] = r.read(n);
                            }
                        }
                    }
                } else {
                    int sfc = g[MP3_SF_COMPRESS];
                    int slen[4], table;
                    if (sfc < 400) {
                        slen[0] = (sfc >> 4) / 5; slen[1] = (sfc >> 4) % 5;
                        slen[2] = (sfc & 15) >> 2; slen[3] = sfc & 3;
                        table = 0;
                    } else if (sfc < 500) {
                        sfc -= 400;
                        slen[0] = (sfc >> 2) / 5; slen[1] = (sfc >> 2) % 5;
                        slen[2] = sfc & 3; slen[3] = 0;
                        table = 1;
                    } else {
                        sfc -= 500;
                        slen[0] = sfc / 3; slen[1] = sfc % 3;
                        slen[2] = 0; slen[3] = 0;
                        table = 2;
                        g[MP3_PREFLAG] = 1;
                    }
                    const int block = bt != 2 ? 0 : (mixed ? 2 : 1);
                    int vals[39];
                    int nv = 0;
                    for (int part = 0; part < 4; ++part)
                        for (int j = 0; j < MP3_NR_OF_SFB[table][block][part];
                             ++j)
                            vals[nv++] = r.read(slen[part]);
                    if (block == 0) {
                        for (int b = 0; b < 21; ++b) sl[b] = vals[b];
                    } else {
                        int v = 0, first = 0;
                        if (block == 2) {
                            for (int b = 0; b < 6; ++b) sl[b] = vals[b];
                            v = 6;
                            first = 3;
                        }
                        for (int b = first; b < 12; ++b)
                            for (int w = 0; w < 3; ++w)
                                ss[3 * b + w] = vals[v++];
                    }
                }
                const int64_t end = gstart[k] + g[MP3_PART2_3];
                if (mp3_huffman_granule(r, end, g, tree, tree_len, starts,
                                        linbits, ix + 576 * k) != 0)
                    return -1;
            }
        }
    }
    return n_decoded;
}

// -- Vorbis ---------------------------------------------------------------------
//
// Vorbis packs bits LSB first. A read past the end of the packet is the
// end-of-packet condition: the position stays at the end and the caller
// stops as the specification says. The codebooks are one binary tree
// (vorbis.py _add_tree: node k's children at 2k and 2k + 1, > 0 a node,
// < 0 the leaf -child - 1, 0 no codeword); a book's VQ values are rows of
// `values` from its offset.

struct VorbisBits {
    const uint8_t* d;
    int64_t n_bits;
    int64_t pos;
    bool eop;
    int bit() {
        if (pos >= n_bits) { eop = true; return 0; }
        const int b = (d[pos >> 3] >> (pos & 7)) & 1;
        ++pos;
        return b;
    }
    int64_t read(int n) {
        if (n == 0) return 0;
        if (pos + n > n_bits) { pos = n_bits; eop = true; return 0; }
        int64_t v = 0;
        for (int i = 0; i < n; ++i)
            v |= int64_t((d[(pos + i) >> 3] >> ((pos + i) & 7)) & 1) << i;
        pos += n;
        return v;
    }
};

// One entry number; -1 at the end of the packet or on a bit string that
// is no codeword (vorbis.py decode_scalar).
static inline int64_t vorbis_scalar(VorbisBits& r, const int32_t* tree,
                                    int64_t tree_len, int64_t root) {
    int64_t node = root;
    for (int depth = 0; depth < 33; ++depth) {
        const int b = r.bit();
        if (r.eop) return -1;
        const int64_t at = 2 * node + b;
        if (at < 0 || at >= tree_len) return -1;
        const int32_t next = tree[at];
        if (next < 0) return -int64_t(next) - 1;
        if (next == 0) return -1;
        node = next;
    }
    return -1;
}

static inline int vorbis_ilog(int64_t x) {
    int n = 0;
    while (x > 0) { ++n; x >>= 1; }
    return n;
}

// The setup as one int32 array (vorbis.py _blob): a header, then each
// book (root, dims, value offset), floor, residue, mapping and mode.
enum {
    VB_CHANNELS, VB_BS0, VB_BS1, VB_N_MODES, VB_N_BOOKS, VB_N_FLOORS,
    VB_N_RESIDUES, VB_N_MAPPINGS, VB_OFF_BOOKS, VB_OFF_FLOORS,
    VB_OFF_RESIDUES, VB_OFF_MAPPINGS, VB_OFF_MODES, VB_HEADER
};

struct VorbisSetup {
    const int32_t* blob;
    int64_t blob_len;
    const int32_t* tree;
    int64_t tree_len;
    const double* values;
    int64_t n_values;
    const double* db;  // floor 1's inverse dB table, 256 entries
    const int32_t* book(int b) const {
        return blob + blob[VB_OFF_BOOKS] + 3 * b;
    }
};

// One channel's floor: its post values, the amplitude unwrap and
// render_line, into curve[half]. Returns 1, or 0 where the floor is unused
// or the packet ends inside it (vorbis.py floor1_values and floor1_curve
// are the plain version), -1 on a setup out of range.
static int vorbis_floor(VorbisBits& r, const VorbisSetup& s,
                        const int32_t* fp, int64_t half, double* curve) {
    const int n_parts = fp[0];
    const int32_t* part_class = fp + 1;
    const int n_classes = fp[1 + n_parts];
    const int32_t* classes = fp + 2 + n_parts;  // 11 ints a class
    const int32_t* tail = classes + 11 * n_classes;
    const int mult = tail[0], n_posts = tail[1];
    const int32_t* xs = tail + 2;
    const int32_t* lo = xs + n_posts;
    const int32_t* hi = lo + (n_posts - 2);
    const int32_t* order = hi + (n_posts - 2);
    if (n_posts < 2 || n_posts > 65 || mult < 1 || mult > 4) return -1;
    static const int range_q[4] = {256, 128, 86, 64};
    const int q = range_q[mult - 1];
    int y[65];
    bool used[65];
    if (r.read(1) == 0 || r.eop) return 0;
    const int bits = vorbis_ilog(q - 1);
    y[0] = static_cast<int>(r.read(bits));
    y[1] = static_cast<int>(r.read(bits));
    if (r.eop) return 0;
    int k = 2;
    for (int p = 0; p < n_parts; ++p) {
        const int c = part_class[p];
        if (c < 0 || c >= n_classes) return -1;
        const int32_t* cl = classes + 11 * c;
        const int cdim = cl[0], csub = cl[1];
        int64_t cval = 0;
        if (csub) {
            cval = vorbis_scalar(r, s.tree, s.tree_len, s.book(cl[2])[0]);
            if (cval < 0) return 0;
        }
        for (int j = 0; j < cdim; ++j) {
            const int book = cl[3 + (cval & ((1 << csub) - 1))];
            cval >>= csub;
            if (k >= n_posts) return -1;
            if (book >= 0) {
                const int64_t v = vorbis_scalar(r, s.tree, s.tree_len,
                                                s.book(book)[0]);
                if (v < 0) return 0;
                y[k++] = static_cast<int>(v);
            } else {
                y[k++] = 0;
            }
        }
    }
    used[0] = used[1] = true;
    for (int i = 2; i < n_posts; ++i) used[i] = false;
    for (int i = 2; i < n_posts; ++i) {
        const int l = lo[i - 2], h = hi[i - 2];
        const int dy = y[h] - y[l];
        const int adx = xs[h] - xs[l];
        const int off = (dy < 0 ? -dy : dy) * (xs[i] - xs[l]) / adx;
        const int pred = dy < 0 ? y[l] - off : y[l] + off;
        int val = y[i];
        const int hiroom = q - pred, loroom = pred;
        const int room = (hiroom < loroom ? hiroom : loroom) * 2;
        if (val) {
            used[l] = used[h] = used[i] = true;
            if (val >= room)
                val = hiroom > loroom ? val - loroom : -1 - (val - hiroom);
            else
                val = (val & 1) ? -((val + 1) >> 1) : val >> 1;
            y[i] = (val + pred) & 0x7FFF;
            y[l] &= 0x7FFF;
            y[h] &= 0x7FFF;
        } else {
            y[i] = pred;
        }
    }
    // render_line between consecutive used posts, in x order
    auto clamp = [](int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); };
    int lx = xs[order[0]], ly = clamp(y[order[0]] * mult);
    for (int j = 1; j < n_posts; ++j) {
        const int cur = order[j];
        if (!used[cur]) continue;
        const int hx = xs[cur], hy = clamp(y[cur] * mult);
        const int dy = hy - ly, adx = hx - lx;
        const int base = dy / adx;
        const int ady = (dy < 0 ? -dy : dy) - (base < 0 ? -base : base) * adx;
        const int sy = dy < 0 ? base - 1 : base + 1;
        const int64_t stop = hx < half ? hx : half;
        int yy = ly, err = 0;
        for (int64_t x = lx; x < stop; ++x) {
            if (x > lx) {
                err += ady;
                if (err >= adx) { err -= adx; yy += sy; }
                else yy += base;
            }
            curve[x] = s.db[yy & 255];
        }
        lx = hx;
        ly = hy;
    }
    for (int64_t x = lx; x < half; ++x) curve[x] = s.db[ly];
    return 1;
}

// Add one submap's residue into vecs (double [ch][half]) as libvorbis does
// for residue types 0, 1 and 2 (vorbis.py residue_decode is the plain
// version), stopping where the packet ends or a codeword is invalid.
// Returns 0, or -1 on a setup out of range.
static int vorbis_residue(VorbisBits& r, const VorbisSetup& s,
                          const int32_t* rp, double* vecs, int64_t ch,
                          int64_t half, const bool* decode) {
    const int kind = rp[0];
    const int64_t begin = rp[1], end = rp[2], grouping = rp[3];
    const int64_t classifications = rp[4];
    const int classbook = rp[5], stages = rp[6];
    const int32_t* books = rp + 7;
    if (grouping <= 0 || classifications <= 0 || stages > 8 || ch <= 0)
        return -1;
    std::vector<int64_t> chans;
    int64_t limit;
    if (kind == 2) {
        bool any = false;
        for (int64_t c = 0; c < ch; ++c) any = any || decode[c];
        if (!any) return 0;
        chans.push_back(0);
        limit = half * ch;
    } else {
        for (int64_t c = 0; c < ch; ++c)
            if (decode[c]) chans.push_back(c);
        if (chans.empty()) return 0;
        limit = half;
    }
    const int64_t stop = end < limit ? end : limit;
    const int64_t size = stop - begin;
    if (size <= 0) return 0;
    const int64_t partvals = size / grouping;
    const int32_t* cb = s.book(classbook);
    const int ppw = cb[1];
    int64_t n_words = 1;
    for (int i = 0; i < ppw; ++i) {
        n_words *= classifications;
        if (n_words > (int64_t(1) << 40)) return -1;
    }
    const int64_t n_partwords = (partvals + ppw - 1) / ppw;
    std::vector<int32_t> cls(chans.size() * n_partwords * ppw, 0);
    for (int st = 0; st < stages; ++st) {
        int64_t i = 0;
        for (int64_t word = 0; i < partvals; ++word) {
            if (st == 0) {
                for (std::size_t j = 0; j < chans.size(); ++j) {
                    int64_t temp = vorbis_scalar(r, s.tree, s.tree_len,
                                                 cb[0]);
                    if (temp < 0 || temp >= n_words) return 0;
                    int32_t* w = &cls[(j * n_partwords + word) * ppw];
                    for (int k = ppw - 1; k >= 0; --k) {
                        w[k] = static_cast<int32_t>(temp % classifications);
                        temp /= classifications;
                    }
                }
            }
            for (int k = 0; k < ppw && i < partvals; ++k, ++i) {
                for (std::size_t j = 0; j < chans.size(); ++j) {
                    const int32_t c = cls[(j * n_partwords + word) * ppw + k];
                    const int32_t b = books[8 * c + st];
                    if (b < 0) continue;
                    const int32_t* bk = s.book(b);
                    const int dim = bk[1];
                    if (bk[2] < 0) return -1;
                    const double* vals = s.values + bk[2];
                    const int64_t off = begin + i * grouping;
                    const int64_t n = grouping;
                    if (kind == 2) {
                        int64_t t = off / ch;
                        const int64_t t_end = (off + n) / ch;
                        int64_t cc = 0;
                        while (t < t_end) {
                            const int64_t e = vorbis_scalar(r, s.tree,
                                                            s.tree_len, bk[0]);
                            if (e < 0) return 0;
                            if (bk[2] + (e + 1) * dim > s.n_values) return -1;
                            for (int d = 0; d < dim && t < t_end; ++d) {
                                vecs[cc * half + t] += vals[e * dim + d];
                                if (++cc == ch) { cc = 0; ++t; }
                            }
                        }
                    } else if (kind == 1) {
                        double* a = vecs + chans[j] * half + off;
                        int64_t t = 0;
                        while (t < n) {
                            const int64_t e = vorbis_scalar(r, s.tree,
                                                            s.tree_len, bk[0]);
                            if (e < 0) return 0;
                            if (bk[2] + (e + 1) * dim > s.n_values) return -1;
                            for (int d = 0; d < dim && t < n; ++d)
                                a[t++] += vals[e * dim + d];
                        }
                    } else {
                        double* a = vecs + chans[j] * half + off;
                        const int64_t step = n / dim;
                        std::vector<int64_t> entries(step);
                        for (int64_t t = 0; t < step; ++t) {
                            entries[t] = vorbis_scalar(r, s.tree, s.tree_len,
                                                       bk[0]);
                            if (entries[t] < 0) return 0;
                            if (bk[2] + (entries[t] + 1) * dim > s.n_values)
                                return -1;
                        }
                        for (int d = 0; d < dim; ++d)
                            for (int64_t t = 0; t < step; ++t)
                                if (d * step + t < n)
                                    a[d * step + t] +=
                                        vals[entries[t] * dim + d];
                    }
                }
            }
        }
    }
    return 0;
}

// Every audio packet's spectrum after its header (vorbis.py decode_body is
// the plain version): floors, residues, the inverse coupling and the floor
// curves, into spec from spec_off[p] as [channels][blocksize / 2].
// packets: [n][4] = byte offset, byte length, bit position after the
// packet's header, mode. Returns 0, or -1 on a setup out of range.
int64_t vorbis_packets(const uint8_t* data, int64_t n_bytes,
                       const int64_t* packets, int64_t n_packets,
                       const int32_t* blob, int64_t blob_len,
                       const int32_t* tree, int64_t tree_len,
                       const double* values, int64_t n_values,
                       const double* db, const int64_t* spec_off,
                       double* spec, int64_t spec_len) {
    VorbisSetup s{blob, blob_len, tree, tree_len, values, n_values, db};
    if (blob_len < VB_HEADER) return -1;
    const int ch = blob[VB_CHANNELS];
    const int32_t* modes = blob + blob[VB_OFF_MODES];
    std::vector<double> tmp;
    std::vector<char> used(ch), nonzero(ch);
    for (int64_t p = 0; p < n_packets; ++p) {
        const int64_t* pk = packets + 4 * p;
        if (pk[0] < 0 || pk[1] < 0 || pk[0] + pk[1] > n_bytes) return -1;
        const int mode = static_cast<int>(pk[3]);
        if (mode < 0 || mode >= blob[VB_N_MODES]) return -1;
        const int flag = modes[2 * mode], mi = modes[2 * mode + 1];
        const int64_t half = blob[flag ? VB_BS1 : VB_BS0] / 2;
        if (spec_off[p] < 0 || spec_off[p] + ch * half > spec_len) return -1;
        double* out = spec + spec_off[p];
        const int32_t* mp = blob + blob[blob[VB_OFF_MAPPINGS] + mi];
        const int n_coupling = mp[0];
        const int32_t* pairs = mp + 1;
        const int n_submaps = mp[1 + 2 * n_coupling];
        const int32_t* mux = mp + 2 + 2 * n_coupling;
        const int32_t* subs = mux + ch;  // (floor, residue) a submap
        VorbisBits r{data + pk[0], pk[1] * 8, pk[2], false};
        for (int c = 0; c < ch; ++c) {
            const int32_t* fp = blob + blob[blob[VB_OFF_FLOORS]
                                            + subs[2 * mux[c]]];
            const int got = vorbis_floor(r, s, fp, half, out + c * half);
            if (got < 0) return -1;
            used[c] = nonzero[c] = static_cast<char>(got);
        }
        for (int i = 0; i < n_coupling; ++i)
            if (nonzero[pairs[2 * i]] || nonzero[pairs[2 * i + 1]])
                nonzero[pairs[2 * i]] = nonzero[pairs[2 * i + 1]] = 1;
        // the curves wait in `out` while the residues decode into tmp
        tmp.assign(static_cast<size_t>(ch) * half, 0.0);
        for (int sm = 0; sm < n_submaps; ++sm) {
            std::vector<int> chans;
            for (int c = 0; c < ch; ++c)
                if (mux[c] == sm) chans.push_back(c);
            if (chans.empty()) continue;
            std::vector<double> vecs(chans.size() * half, 0.0);
            bool dec[256];
            for (std::size_t j = 0; j < chans.size(); ++j)
                dec[j] = nonzero[chans[j]] != 0;
            const int32_t* rp = blob + blob[blob[VB_OFF_RESIDUES]
                                            + subs[2 * sm + 1]];
            if (vorbis_residue(r, s, rp, vecs.data(),
                               static_cast<int64_t>(chans.size()), half,
                               dec) < 0)
                return -1;
            for (std::size_t j = 0; j < chans.size(); ++j)
                for (int64_t t = 0; t < half; ++t)
                    tmp[chans[j] * half + t] = vecs[j * half + t];
        }
        for (int i = n_coupling - 1; i >= 0; --i) {
            double* m = tmp.data() + pairs[2 * i] * half;
            double* a = tmp.data() + pairs[2 * i + 1] * half;
            for (int64_t t = 0; t < half; ++t) {
                const double mag = m[t], ang = a[t];
                if (ang > 0) {
                    m[t] = mag;
                    a[t] = mag > 0 ? mag - ang : mag + ang;
                } else {
                    m[t] = mag > 0 ? mag + ang : mag - ang;
                    a[t] = mag;
                }
            }
        }
        for (int c = 0; c < ch; ++c) {
            double* o = out + c * half;
            const double* v = tmp.data() + c * half;
            if (!used[c]) {
                for (int64_t t = 0; t < half; ++t) o[t] = 0.0;
            } else {
                for (int64_t t = 0; t < half; ++t) o[t] = v[t] * o[t];
            }
        }
    }
    return 0;
}


// MPEG audio Layer I and II (audio/mpa.py): one call reads every frame of
// a block: the bit allocation (4 bits a subband in Layer I; in Layer II
// nbal bits of the frame's allocation table, alloc[tab][sb][0]), Layer
// II's scfsi, the scale factors and the sample codes; an ungrouped code
// comes out less 2^(bits-1) - 1, a 3-, 5- or 9-level code as its three
// digits. Above the intensity bound one code serves both channels. Reads
// past a frame's end give zero bits. Returns the frames read, or -1.
int64_t mpa_frames(const uint8_t* data, int64_t n_bytes, const int64_t* table,
                   int64_t n_frames, int layer, int nch,
                   const int32_t* alloc, const int32_t* classes,
                   int32_t* cls, int32_t* scf, int32_t* code) {
    const int S = layer == 1 ? 12 : 36;
    for (int64_t f = 0; f < n_frames; ++f) {
        const int64_t* t = table + f * 6;
        const int64_t pos = t[0], crc = t[1], mode = t[2], ext = t[3];
        const int64_t size = t[4], tab = t[5];
        if (pos < 0 || size < 4 || pos + size > n_bytes) return -1;
        if (layer == 2 && (tab < 0 || tab > 4)) return -1;
        Mp3Bits r{data, 8 * (pos + size), 8 * (pos + 4 + 2 * crc)};
        int32_t* fc = cls + f * nch * 32;
        int32_t* fs = scf + f * nch * 32 * 3;
        int32_t* fx = code + f * S * nch * 32;
        const int32_t* at = alloc + (layer == 2 ? tab : 0) * 32 * 17;
        int sblimit = 32;
        if (layer == 2) {
            sblimit = 0;
            while (sblimit < 32 && at[sblimit * 17] > 0) ++sblimit;
        }
        int bound = sblimit;
        if (nch == 2 && mode == 1) {
            bound = 4 * (int)ext + 4;
            if (bound > sblimit) bound = sblimit;
        }
        for (int sb = 0; sb < sblimit; ++sb) {
            const int nc = sb < bound ? nch : 1;
            for (int c = 0; c < nc; ++c) {
                int k = 0;
                if (layer == 1) {
                    // the class of a + 1 bits (CLASSES: 2 bits is 4)
                    const int a = r.read(4);
                    k = a ? 3 + a : 0;
                } else {
                    const int a = r.read(at[sb * 17]);
                    k = a ? at[sb * 17 + 1 + a] : 0;
                }
                fc[c * 32 + sb] = k;
            }
            if (sb >= bound) fc[32 + sb] = fc[sb];
        }
        if (layer == 1) {
            for (int sb = 0; sb < 32; ++sb)
                for (int c = 0; c < nch; ++c)
                    if (fc[c * 32 + sb]) {
                        const int v = r.read(6);
                        for (int j = 0; j < 3; ++j)
                            fs[(c * 32 + sb) * 3 + j] = v;
                    }
        } else {
            int scfsi[2][32] = {{0}};
            for (int sb = 0; sb < sblimit; ++sb)
                for (int c = 0; c < nch; ++c)
                    if (fc[c * 32 + sb]) scfsi[c][sb] = r.read(2);
            for (int sb = 0; sb < sblimit; ++sb)
                for (int c = 0; c < nch; ++c) {
                    if (!fc[c * 32 + sb]) continue;
                    int32_t* v = fs + (c * 32 + sb) * 3;
                    switch (scfsi[c][sb]) {
                    case 0: v[0] = r.read(6); v[1] = r.read(6);
                        v[2] = r.read(6); break;
                    case 1: v[0] = v[1] = r.read(6); v[2] = r.read(6); break;
                    case 2: v[0] = v[1] = v[2] = r.read(6); break;
                    default: v[0] = r.read(6); v[1] = v[2] = r.read(6);
                    }
                }
        }
        const int per = layer == 1 ? 1 : 3;
        for (int g = 0; g < 12; ++g)
            for (int sb = 0; sb < sblimit; ++sb) {
                const int nc = sb < bound ? nch : 1;
                for (int c = 0; c < nc; ++c) {
                    const int k = fc[c * 32 + sb];
                    if (!k) continue;
                    const int bits = classes[2 * k], lv = classes[2 * k + 1];
                    int32_t* x = fx + (g * per * nch + c) * 32 + sb;
                    if (lv) {
                        int v = r.read(bits);
                        // a code past lv^3 reads as zeros (digit 9), as
                        // mpg123's tables have it
                        const bool valid = v < lv * lv * lv;
                        for (int j = 0; j < 3; ++j) {
                            x[j * nch * 32] = valid ? v % lv : 9;
                            v /= lv;
                        }
                    } else {
                        const int off = (1 << (bits - 1)) - 1;
                        for (int j = 0; j < per; ++j)
                            x[j * nch * 32] = r.read(bits) - off;
                    }
                }
                if (sb >= bound)
                    for (int j = 0; j < per; ++j) {
                        int32_t* x = fx + ((g * per + j) * nch) * 32 + sb;
                        x[32] = x[0];
                    }
            }
    }
    return n_frames;
}


}  // extern "C"

// ---------------------------------------------------------------------------
// Opus (audio/opus_range.py, audio/celt.py, audio/silk.py, audio/ogg_opus.py)
//
// The range decoder (RFC 6716 4.1), CELT's range-coded frame up to its
// denormalised MDCT coefficients and its post-filter and de-emphasis, SILK
// (integer arithmetic, a C++ object per stream holding its state), and
// opusfile's soft clip and noise-shaped dither. The tables come from Python
// (audio/native.py opus_blob, in the order of OpusTable). CELT computes in
// double precision in the same order as its plain version, so the two
// decode to the same bits; the IMDCT between the frame and the post-filter
// is numpy's, shared by both.

enum OpusTable {
    T_EBANDS, T_ALLOC_VECTORS, T_E_PROB_MODEL, T_CACHE_INDEX, T_CACHE_BITS,
    T_CACHE_CAPS, T_LOGN, T_LOG2_FRAC, T_TF_SELECT, T_SMALL_ENERGY_ICDF,
    T_TRIM_ICDF, T_SPREAD_ICDF, T_TAPSET_ICDF,
    S_GAIN_ICDF, S_DELTA_GAIN_ICDF, S_PITCH_LAG_ICDF, S_PITCH_DELTA_ICDF,
    S_PITCH_CONTOUR_ICDF, S_PITCH_CONTOUR_NB_ICDF, S_PITCH_CONTOUR_10MS_ICDF,
    S_PITCH_CONTOUR_10MS_NB_ICDF, S_CB_LAGS_STAGE2, S_CB_LAGS_STAGE3,
    S_CB_LAGS_STAGE2_10MS, S_CB_LAGS_STAGE3_10MS, S_LTP_PER_INDEX_ICDF,
    S_LTP_GAIN_ICDF_0, S_LTP_GAIN_ICDF_1, S_LTP_GAIN_ICDF_2, S_LTP_VQ_0,
    S_LTP_VQ_1, S_LTP_VQ_2, S_LTPSCALE_ICDF, S_LTP_SCALES_Q14,
    S_TYPE_OFFSET_VAD_ICDF, S_TYPE_OFFSET_NO_VAD_ICDF, S_NLSF_INTERP_ICDF,
    S_NLSF_EXT_ICDF, S_UNIFORM3_ICDF, S_UNIFORM4_ICDF, S_UNIFORM5_ICDF,
    S_UNIFORM6_ICDF, S_UNIFORM8_ICDF, S_QUANT_OFFSETS_Q10, S_LSB_ICDF,
    S_LBRR_FLAGS_3_ICDF, S_LBRR_FLAGS_2_ICDF, S_STEREO_ONLY_MID_ICDF,
    S_STEREO_PRED_JOINT_ICDF, S_STEREO_PRED_QUANT_Q13, S_RATE_LEVELS_ICDF,
    S_PULSES_PER_BLOCK_ICDF, S_SHELL_CODE_TABLE0, S_SHELL_CODE_TABLE1,
    S_SHELL_CODE_TABLE2, S_SHELL_CODE_TABLE3, S_SHELL_CODE_TABLE_OFFSETS,
    S_SIGN_ICDF, S_LSF_COS_TAB_Q12, S_NLSF_NB_MB_CB1_Q8,
    S_NLSF_NB_MB_CB1_WGHT_Q9, S_NLSF_NB_MB_CB1_ICDF, S_NLSF_NB_MB_CB2_SELECT,
    S_NLSF_NB_MB_CB2_ICDF, S_NLSF_NB_MB_PRED_Q8, S_NLSF_NB_MB_DELTA_MIN_Q15,
    S_NLSF_WB_CB1_Q8, S_NLSF_WB_CB1_WGHT_Q9, S_NLSF_WB_CB1_ICDF,
    S_NLSF_WB_CB2_SELECT, S_NLSF_WB_CB2_ICDF, S_NLSF_WB_PRED_Q8,
    S_NLSF_WB_DELTA_MIN_Q15, S_RESAMPLER_FRAC_FIR_12, S_DELAY_MATRIX_DEC,
    S_RESAMPLER_UP2_HQ_0, S_RESAMPLER_UP2_HQ_1, OPUS_TABLE_COUNT
};

struct OpusTabs {
    const int32_t* blob;
    const int64_t* off;
    const int32_t* operator[](int t) const { return blob + off[t]; }
};

// -- the range decoder -------------------------------------------------------

struct OpusRange {
    const uint8_t* buf;
    int64_t storage, offs, end_offs, end_window, nend_bits, nbits_total;
    uint32_t rng, val, rem, ext;
    int error;

    void load(const uint8_t* b, const int64_t* s) {
        buf = b;
        storage = s[0]; offs = s[1]; end_offs = s[2]; end_window = s[3];
        nend_bits = s[4]; nbits_total = s[5];
        rng = (uint32_t)s[6]; val = (uint32_t)s[7]; rem = (uint32_t)s[8];
        ext = (uint32_t)s[9]; error = (int)s[10];
    }
    void store(int64_t* s) const {
        s[0] = storage; s[1] = offs; s[2] = end_offs; s[3] = end_window;
        s[4] = nend_bits; s[5] = nbits_total; s[6] = rng; s[7] = val;
        s[8] = rem; s[9] = ext; s[10] = error;
    }
    int byte() { return offs < storage ? buf[offs++] : 0; }
    int byte_from_end() {
        return end_offs < storage ? buf[storage - ++end_offs] : 0;
    }
    void normalize() {
        while (rng <= (1u << 23)) {
            nbits_total += 8;
            rng <<= 8;
            uint32_t sym = rem;
            rem = (uint32_t)byte();
            sym = ((sym << 8) | rem) >> 1;
            val = ((val << 8) + (255u & ~sym)) & 0x7FFFFFFFu;
        }
    }
    uint32_t decode(uint32_t ft) {
        ext = rng / ft;
        uint32_t s = val / ext;
        return ft - (s + 1 < ft ? s + 1 : ft);
    }
    uint32_t decode_bin(int bits) {
        ext = rng >> bits;
        uint32_t s = val / ext;
        uint32_t t = 1u << bits;
        return t - (s + 1 < t ? s + 1 : t);
    }
    void update(uint32_t fl, uint32_t fh, uint32_t ft) {
        uint32_t s = ext * (ft - fh);
        val -= s;
        rng = fl > 0 ? ext * (fh - fl) : rng - s;
        normalize();
    }
    int bit_logp(int logp) {
        uint32_t r = rng, d = val, s = r >> logp;
        int ret = d < s;
        if (!ret) val = d - s;
        rng = ret ? s : r - s;
        normalize();
        return ret;
    }
    template <typename I>
    int icdf(const I* t, int ftb) {
        uint32_t s = rng, d = val, r = s >> ftb, u;
        int ret = -1;
        do {
            u = s;
            s = r * (uint32_t)t[++ret];
        } while (d < s);
        val = d - s;
        rng = u - s;
        normalize();
        return ret;
    }
    static int ilog(uint32_t x) {
        int n = 0;
        while (x) { ++n; x >>= 1; }
        return n;
    }
    uint32_t bits(int n) {
        uint64_t window = (uint64_t)end_window;
        int64_t available = nend_bits;
        if (available < n) {
            do {
                window |= (uint64_t)byte_from_end() << available;
                available += 8;
            } while (available <= 24);
        }
        uint32_t ret = (uint32_t)(window & ((1ull << n) - 1));
        end_window = (int64_t)(window >> n);
        nend_bits = available - n;
        nbits_total += n;
        return ret;
    }
    uint32_t uint(uint32_t ft) {
        ft--;
        int ftb = ilog(ft);
        if (ftb > 8) {
            ftb -= 8;
            uint32_t f = (ft >> ftb) + 1;
            uint32_t s = decode(f);
            update(s, s + 1, f);
            uint32_t t = (s << ftb) | bits(ftb);
            if (t <= ft) return t;
            error = 1;
            return ft;
        }
        ft++;
        uint32_t s = decode(ft);
        update(s, s + 1, ft);
        return s;
    }
    int64_t tell() const { return nbits_total - ilog(rng); }
    int64_t tell_frac() const {
        int64_t nbits = nbits_total << 3;
        int l = ilog(rng);
        uint32_t r = rng >> (l - 16);
        for (int i = 0; i < 3; ++i) {
            r = (uint32_t)(((uint64_t)r * r) >> 15);
            int b = (int)(r >> 16);
            l = (l << 1) | b;
            r >>= b;
        }
        return nbits - l;
    }
};

// -- CELT: integer helpers -------------------------------------------------------

static const int CELT_NB = 21;

static inline int tdiv(int a, int b) { return a / b; }  // C truncates

static inline int16_t as_i16(int x) { return (int16_t)(uint16_t)(x & 0xFFFF); }

static inline int frac_mul16(int a, int b) {
    return (16384 + (int)as_i16(a) * (int)as_i16(b)) >> 15;
}

static int bitexact_cos(int x) {
    int tmp = (4096 + x * x) >> 13;
    int x2 = as_i16(tmp);
    x2 = (32767 - x2) + frac_mul16(x2, (-7651 + frac_mul16(
        x2, (8277 + frac_mul16(-626, x2)))));
    return 1 + as_i16(x2);
}

static int bitexact_log2tan(int isin, int icos) {
    int lc = OpusRange::ilog((uint32_t)icos);
    int ls = OpusRange::ilog((uint32_t)isin);
    icos <<= 15 - lc;
    isin <<= 15 - ls;
    return (ls - lc) * (1 << 11)
        + frac_mul16(isin, frac_mul16(isin, -2597) + 7932)
        - frac_mul16(icos, frac_mul16(icos, -2597) + 7932);
}

static inline uint32_t lcg_rand(uint32_t seed) {
    return 1664525u * seed + 1013904223u;
}

// U(n, k) of the PVQ codebook sizes, saturating (every value cwrsi reads
// is below 2^32)
static const uint64_t* pvq_table() {
    static std::vector<uint64_t> t = [] {
        const int N = 260, K = 260;
        std::vector<uint64_t> u((size_t)N * K, 0);
        const uint64_t cap = 1ull << 62;
        for (int n = 0; n < N; ++n)
            for (int k = 0; k < K; ++k) {
                uint64_t v;
                if (n == 0) v = k == 0;
                else if (k == 0) v = 0;
                else {
                    v = u[(size_t)(n - 1) * K + k] + u[(size_t)n * K + k - 1]
                        + u[(size_t)(n - 1) * K + k - 1];
                    if (v > cap) v = cap;
                }
                u[(size_t)n * K + k] = v;
            }
        return u;
    }();
    return t.data();
}

static inline uint64_t pvq_u(int n, int k) {
    if (n < 0 || k < 0 || n >= 260 || k >= 260) return 1ull << 62;
    return pvq_table()[(size_t)n * 260 + k];
}

static double cwrsi(int n, int k, uint64_t i, int* y) {
    double yy = 0.0;
    int pos = 0;
    while (n > 2) {
        if (k >= n) {
            uint64_t p = pvq_u(n, k + 1);
            int s = -(int)(i >= p);
            i -= p & (uint64_t)(int64_t)s;
            int k0 = k;
            uint64_t q = pvq_u(n, n);
            if (q > i) {
                k = n;
                do { p = pvq_u(--k, n); } while (p > i);
            } else {
                for (p = pvq_u(n, k); p > i; p = pvq_u(n, k)) k--;
            }
            i -= p;
            int val = (k0 - k + s) ^ s;
            y[pos++] = val;
            yy += (double)val * val;
        } else {
            uint64_t p = pvq_u(k, n), q = pvq_u(k + 1, n);
            if (p <= i && i < q) {
                i -= p;
                y[pos++] = 0;
            } else {
                int s = -(int)(i >= q);
                i -= q & (uint64_t)(int64_t)s;
                int k0 = k;
                do { p = pvq_u(--k, n); } while (p > i);
                i -= p;
                int val = (k0 - k + s) ^ s;
                y[pos++] = val;
                yy += (double)val * val;
            }
        }
        n--;
    }
    uint64_t p = 2 * (uint64_t)k + 1;
    int s = -(int)(i >= p);
    i -= p & (uint64_t)(int64_t)s;
    int k0 = k;
    k = (int)((i + 1) >> 1);
    if (k) i -= 2 * (uint64_t)k - 1;
    int val = (k0 - k + s) ^ s;
    y[pos++] = val;
    yy += (double)val * val;
    s = -(int)i;
    val = (k + s) ^ s;
    y[pos] = val;
    yy += (double)val * val;
    return yy;
}

// -- CELT: energy, allocation, bands ------------------------------------------------

static const double CELT_PRED_COEF[4] = {29440 / 32768.0, 26112 / 32768.0,
                                         21248 / 32768.0, 16384 / 32768.0};
static const double CELT_BETA_COEF[4] = {30147 / 32768.0, 22282 / 32768.0,
                                         12124 / 32768.0, 6554 / 32768.0};
static const double CELT_BETA_INTRA = 4915 / 32768.0;
static const double CELT_E_MEANS[21] = {
    6.4375, 6.25, 5.75, 5.3125, 5.0625, 4.8125, 4.5, 4.375, 4.875, 4.6875,
    4.5625, 4.4375, 4.875, 4.625, 4.3125, 4.5, 4.375, 4.625, 4.75, 4.4375,
    3.75};
static const double CELT_LN2 = 0.6931471805599453094;

static inline double celt_exp2(double x) { return std::exp(CELT_LN2 * x); }

struct CeltCtx {
    OpusRange* rd;
    OpusTabs T;
    const int32_t* eb;
    int i, intensity, spread, tf_change, remaining_bits, disable_inv;
    uint32_t seed;
};

static int laplace_decode(OpusRange& rd, int fs, int decay) {
    int val = 0;
    int fm = (int)rd.decode_bin(15);
    int fl = 0;
    if (fm >= fs) {
        val++;
        fl = fs;
        fs = (((32768 - 32 - fs) * (16384 - decay)) >> 15) + 1;
        while (fs > 1 && fm >= fl + 2 * fs) {
            fs *= 2;
            fl += fs;
            fs = (((fs - 2) * decay) >> 15) + 1;
            val++;
        }
        if (fs <= 1) {
            int di = (fm - fl) >> 1;
            val += di;
            fl += 2 * di;
        }
        if (fm < fl + fs) val = -val;
        else fl += fs;
    }
    rd.update((uint32_t)fl, (uint32_t)(fl + fs < 32768 ? fl + fs : 32768),
              32768);
    return val;
}

static int bits2pulses(const OpusTabs& T, int band, int LM, int bits) {
    const int32_t* cache = T[T_CACHE_BITS] + T[T_CACHE_INDEX][(LM + 1) * 21 + band];
    int lo = 0, hi = cache[0];
    bits--;
    for (int i = 0; i < 6; ++i) {
        int mid = (lo + hi + 1) >> 1;
        if (cache[mid] >= bits) hi = mid;
        else lo = mid;
    }
    if (bits - (lo == 0 ? -1 : cache[lo]) <= cache[hi] - bits) return lo;
    return hi;
}

static int pulses2bits(const OpusTabs& T, int band, int LM, int pulses) {
    const int32_t* cache = T[T_CACHE_BITS] + T[T_CACHE_INDEX][(LM + 1) * 21 + band];
    return pulses == 0 ? 0 : cache[pulses] + 1;
}

static inline int get_pulses(int i) {
    return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1);
}

static void exp_rotation1(double* x, int len, int stride, double c,
                          double s) {
    double ms = -s;
    for (int i = 0; i < len - stride; ++i) {
        double x1 = x[i], x2 = x[i + stride];
        x[i + stride] = c * x2 + s * x1;
        x[i] = c * x1 + ms * x2;
    }
    for (int i = len - 2 * stride - 1; i >= 0; --i) {
        double x1 = x[i], x2 = x[i + stride];
        x[i + stride] = c * x2 + s * x1;
        x[i] = c * x1 + ms * x2;
    }
}

static void exp_rotation(double* x, int len, int stride, int K, int spread) {
    static const int factors[3] = {15, 10, 5};
    if (2 * K >= len || spread == 0) return;
    int factor = factors[spread - 1];
    double gain = (double)len / (double)(len + factor * K);
    double theta = 0.5 * (gain * gain);
    double c = std::cos(0.5 * M_PI * theta);
    double s = std::cos(0.5 * M_PI * (1.0 - theta));
    int stride2 = 0;
    if (len >= 8 * stride) {
        stride2 = 1;
        while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < len)
            stride2++;
    }
    len /= stride;
    for (int i = 0; i < stride; ++i) {
        if (stride2) exp_rotation1(x + i * len, len, stride2, s, c);
        exp_rotation1(x + i * len, len, 1, c, s);
    }
}

static unsigned alg_unquant(CeltCtx& ctx, double* x, int n, int K,
                            int spread, int B, double gain) {
    std::vector<int> iy((size_t)n);
    uint64_t ft = pvq_u(n, K) + pvq_u(n, K + 1);
    if (ft > 0xFFFFFFFFull) { ctx.rd->error = 2; ft = 0xFFFFFFFFull; }
    double ryy = cwrsi(n, K, ctx.rd->uint((uint32_t)ft), iy.data());
    double g = (1.0 / std::sqrt(ryy)) * gain;
    for (int i = 0; i < n; ++i) x[i] = g * iy[i];
    exp_rotation(x, n, B, K, spread);
    if (B <= 1) return 1;
    int n0 = n / B;
    unsigned mask = 0;
    for (int i = 0; i < B; ++i) {
        int any = 0;
        for (int j = 0; j < n0; ++j) any |= iy[(size_t)i * n0 + j];
        mask |= (unsigned)(any != 0) << i;
    }
    return mask;
}

static void renormalise(double* x, int n, double gain) {
    double e = 1e-15;
    for (int i = 0; i < n; ++i) e += x[i] * x[i];
    double g = (1.0 / std::sqrt(e)) * gain;
    for (int i = 0; i < n; ++i) x[i] = g * x[i];
}

static const double CELT_HAAR = (double)0.70710678f;

static void haar1(double* x, int n0, int stride) {
    n0 >>= 1;
    for (int i = 0; i < stride; ++i)
        for (int j = 0; j < n0; ++j) {
            double* a = x + stride * 2 * j + i;
            double* b = x + stride * (2 * j + 1) + i;
            double t1 = CELT_HAAR * *a, t2 = CELT_HAAR * *b;
            *a = t1 + t2;
            *b = t1 - t2;
        }
}

static const int ORDERY[30] = {1, 0, 3, 0, 2, 1, 7, 0, 4, 3, 6, 1, 5, 2, 15,
                               0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10,
                               5};

static void deinterleave_hadamard(double* x, int n0, int stride,
                                  int hadamard) {
    int n = n0 * stride;
    std::vector<double> tmp((size_t)n);
    for (int i = 0; i < stride; ++i)
        for (int j = 0; j < n0; ++j) {
            int row = hadamard ? ORDERY[stride - 2 + i] : i;
            tmp[(size_t)row * n0 + j] = x[j * stride + i];
        }
    for (int i = 0; i < n; ++i) x[i] = tmp[(size_t)i];
}

static void interleave_hadamard(double* x, int n0, int stride, int hadamard) {
    int n = n0 * stride;
    std::vector<double> tmp((size_t)n);
    for (int i = 0; i < stride; ++i)
        for (int j = 0; j < n0; ++j) {
            int row = hadamard ? ORDERY[stride - 2 + i] : i;
            tmp[(size_t)j * stride + i] = x[row * n0 + j];
        }
    for (int i = 0; i < n; ++i) x[i] = tmp[(size_t)i];
}

static int compute_qn(int n, int b, int offset, int pulse_cap, int stereo) {
    static const int exp2_table8[8] = {16384, 17866, 19483, 21247, 23170,
                                       25267, 27554, 30048};
    int n2 = 2 * n - 1;
    if (stereo && n == 2) n2--;
    int qb = tdiv(b + n2 * offset, n2);
    qb = b - pulse_cap - (4 << 3) < qb ? b - pulse_cap - (4 << 3) : qb;
    qb = (8 << 3) < qb ? (8 << 3) : qb;
    if (qb < (1 << 3 >> 1)) return 1;
    int qn = exp2_table8[qb & 0x7] >> (14 - (qb >> 3));
    return (qn + 1) >> 1 << 1;
}

struct Theta { int b, fill, inv, imid, iside, delta, itheta, qalloc; };

static Theta compute_theta(CeltCtx& ctx, int n, int b, int B, int B0, int LM,
                           int stereo, int fill) {
    OpusRange& rd = *ctx.rd;
    int i = ctx.i;
    int pulse_cap = ctx.T[T_LOGN][i] + LM * (1 << 3);
    int offset = (pulse_cap >> 1) - (stereo && n == 2 ? 16 : 4);
    int qn = compute_qn(n, b, offset, pulse_cap, stereo);
    if (stereo && i >= ctx.intensity) qn = 1;
    int64_t tell = rd.tell_frac();
    int itheta = 0, inv = 0;
    if (qn != 1) {
        if (stereo && n > 2) {
            int p0 = 3, x0 = qn / 2, ft = p0 * (x0 + 1) + x0;
            int fs = (int)rd.decode((uint32_t)ft);
            int x = fs < (x0 + 1) * p0 ? fs / p0 : x0 + 1 + (fs - (x0 + 1) * p0);
            if (x <= x0) rd.update((uint32_t)(p0 * x), (uint32_t)(p0 * (x + 1)),
                                   (uint32_t)ft);
            else rd.update((uint32_t)((x - 1 - x0) + (x0 + 1) * p0),
                           (uint32_t)((x - x0) + (x0 + 1) * p0), (uint32_t)ft);
            itheta = x;
        } else if (B0 > 1 || stereo) {
            itheta = (int)rd.uint((uint32_t)(qn + 1));
        } else {
            int ft = ((qn >> 1) + 1) * ((qn >> 1) + 1);
            int fm = (int)rd.decode((uint32_t)ft);
            int fs, fl;
            if (fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1)) {
                itheta = ((int)std::sqrt((double)(8 * (uint32_t)fm + 1)) - 1) >> 1;
                fs = itheta + 1;
                fl = itheta * (itheta + 1) >> 1;
            } else {
                itheta = (2 * (qn + 1)
                          - (int)std::sqrt((double)(8 * (uint32_t)(ft - fm - 1) + 1))) >> 1;
                fs = qn + 1 - itheta;
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
            }
            rd.update((uint32_t)fl, (uint32_t)(fl + fs), (uint32_t)ft);
        }
        itheta = (int)(((int64_t)itheta * 16384) / qn);
    } else if (stereo) {
        if (b > 2 << 3 && ctx.remaining_bits > 2 << 3) inv = rd.bit_logp(2);
        if (ctx.disable_inv) inv = 0;
        itheta = 0;
    }
    int qalloc = (int)(rd.tell_frac() - tell);
    b -= qalloc;
    Theta t;
    if (itheta == 0) {
        t.imid = 32767; t.iside = 0;
        fill &= (1 << B) - 1;
        t.delta = -16384;
    } else if (itheta == 16384) {
        t.imid = 0; t.iside = 32767;
        fill &= ((1 << B) - 1) << B;
        t.delta = 16384;
    } else {
        t.imid = bitexact_cos(itheta);
        t.iside = bitexact_cos(16384 - itheta);
        t.delta = frac_mul16((n - 1) << 7, bitexact_log2tan(t.iside, t.imid));
    }
    t.b = b; t.fill = fill; t.inv = inv; t.itheta = itheta; t.qalloc = qalloc;
    return t;
}

static unsigned quant_partition(CeltCtx& ctx, double* x, int n, int b, int B,
                                double* lowband, int LM, double gain,
                                int fill) {
    const OpusTabs& T = ctx.T;
    int i = ctx.i;
    int B0 = B;
    const int32_t* cache = T[T_CACHE_BITS] + T[T_CACHE_INDEX][(LM + 1) * 21 + i];
    if (LM != -1 && b > cache[cache[0]] + 12 && n > 2) {
        n >>= 1;
        double* y = x + n;
        LM -= 1;
        if (B == 1) fill = (fill & 1) | (fill << 1);
        B = (B + 1) >> 1;
        Theta t = compute_theta(ctx, n, b, B, B0, LM, 0, fill);
        b = t.b; fill = t.fill;
        int delta = t.delta, itheta = t.itheta;
        double mid = (1.0 / 32768) * t.imid, side = (1.0 / 32768) * t.iside;
        if (B0 > 1 && (itheta & 0x3fff)) {
            if (itheta > 8192) delta -= delta >> (4 - LM);
            else {
                int v = delta + (n << 3 >> (5 - LM));
                delta = v < 0 ? v : 0;
            }
        }
        int half = tdiv(b - delta, 2);
        int mbits = b < half ? b : half;
        if (mbits < 0) mbits = 0;
        int sbits = b - mbits;
        ctx.remaining_bits -= t.qalloc;
        double* lb2 = lowband ? lowband + n : nullptr;
        int rebalance = ctx.remaining_bits;
        unsigned cm;
        if (mbits >= sbits) {
            cm = quant_partition(ctx, x, n, mbits, B, lowband, LM, gain * mid, fill);
            rebalance = mbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << 3 && itheta != 0) sbits += rebalance - (3 << 3);
            cm |= quant_partition(ctx, y, n, sbits, B, lb2, LM, gain * side,
                                  fill >> B) << (B0 >> 1);
        } else {
            cm = quant_partition(ctx, y, n, sbits, B, lb2, LM, gain * side,
                                 fill >> B) << (B0 >> 1);
            rebalance = sbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << 3 && itheta != 16384) mbits += rebalance - (3 << 3);
            cm |= quant_partition(ctx, x, n, mbits, B, lowband, LM, gain * mid, fill);
        }
        return cm;
    }
    int q = bits2pulses(T, i, LM, b);
    int curr = pulses2bits(T, i, LM, q);
    ctx.remaining_bits -= curr;
    while (ctx.remaining_bits < 0 && q > 0) {
        ctx.remaining_bits += curr;
        q--;
        curr = pulses2bits(T, i, LM, q);
        ctx.remaining_bits -= curr;
    }
    if (q != 0)
        return alg_unquant(ctx, x, n, get_pulses(q), ctx.spread, B, gain);
    unsigned cm_mask = (unsigned)((1ul << B) - 1);
    fill &= (int)cm_mask;
    if (!fill) {
        for (int j = 0; j < n; ++j) x[j] = 0.0;
        return 0;
    }
    unsigned cm;
    if (!lowband) {
        for (int j = 0; j < n; ++j) {
            ctx.seed = lcg_rand(ctx.seed);
            x[j] = (double)((int32_t)ctx.seed >> 20);
        }
        cm = cm_mask;
    } else {
        for (int j = 0; j < n; ++j) {
            ctx.seed = lcg_rand(ctx.seed);
            double tmp = (ctx.seed & 0x8000) ? 1.0 / 256 : -1.0 / 256;
            x[j] = lowband[j] + tmp;
        }
        cm = (unsigned)fill;
    }
    renormalise(x, n, gain);
    return cm;
}

static unsigned quant_band_n1(CeltCtx& ctx, double* x, double* y,
                              double* lowband_out) {
    double* arrs[2] = {x, y};
    for (int c = 0; c < 2; ++c) {
        if (!arrs[c]) continue;
        int sign = 0;
        if (ctx.remaining_bits >= 1 << 3) {
            sign = (int)ctx.rd->bits(1);
            ctx.remaining_bits -= 1 << 3;
        }
        arrs[c][0] = sign ? -1.0 : 1.0;
    }
    if (lowband_out) lowband_out[0] = x[0];
    return 1;
}

static unsigned quant_band(CeltCtx& ctx, double* x, int n, int b, int B,
                           double* lowband, int LM, double* lowband_out,
                           double gain, double* scratch, int fill) {
    static const unsigned char bit_interleave[16] = {0, 1, 1, 1, 2, 3, 3, 3,
                                                     2, 3, 3, 3, 2, 3, 3, 3};
    static const unsigned char bit_deinterleave[16] = {
        0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F, 0xC0, 0xC3, 0xCC,
        0xCF, 0xF0, 0xF3, 0xFC, 0xFF};
    int n0 = n, n_b = n, B0 = B, time_divide = 0, recombine = 0;
    int long_blocks = B0 == 1;
    n_b /= B;
    if (n == 1) return quant_band_n1(ctx, x, nullptr, lowband_out);
    int tf_change = ctx.tf_change;
    if (tf_change > 0) recombine = tf_change;
    if (scratch && lowband &&
        (recombine || ((n_b & 1) == 0 && tf_change < 0) || B0 > 1)) {
        for (int j = 0; j < n; ++j) scratch[j] = lowband[j];
        lowband = scratch;
    }
    for (int k = 0; k < recombine; ++k) {
        if (lowband) haar1(lowband, n >> k, 1 << k);
        fill = bit_interleave[fill & 0xF] | bit_interleave[fill >> 4] << 2;
    }
    B >>= recombine;
    n_b <<= recombine;
    while ((n_b & 1) == 0 && tf_change < 0) {
        if (lowband) haar1(lowband, n_b, B);
        fill |= fill << B;
        B <<= 1;
        n_b >>= 1;
        time_divide++;
        tf_change++;
    }
    B0 = B;
    int n_b0 = n_b;
    if (B0 > 1 && lowband)
        deinterleave_hadamard(lowband, n_b >> recombine, B0 << recombine,
                              long_blocks);
    unsigned cm = quant_partition(ctx, x, n, b, B, lowband, LM, gain, fill);
    if (B0 > 1)
        interleave_hadamard(x, n_b >> recombine, B0 << recombine, long_blocks);
    n_b = n_b0;
    B = B0;
    for (int k = 0; k < time_divide; ++k) {
        B >>= 1;
        n_b <<= 1;
        cm |= cm >> B;
        haar1(x, n_b, B);
    }
    for (int k = 0; k < recombine; ++k) {
        cm = bit_deinterleave[cm];
        haar1(x, n0 >> k, 1 << k);
    }
    B <<= recombine;
    if (lowband_out) {
        double nn = std::sqrt((double)n0);
        for (int j = 0; j < n0; ++j) lowband_out[j] = nn * x[j];
    }
    return cm & ((1u << B) - 1);
}

static void stereo_merge(double* x, double* y, double mid, int n) {
    double xp = 0.0, side = 0.0;
    for (int j = 0; j < n; ++j) {
        xp += y[j] * x[j];
        side += y[j] * y[j];
    }
    xp = mid * xp;
    double mid2 = mid;
    double el = mid2 * mid2 + side - 2 * xp;
    double er = mid2 * mid2 + side + 2 * xp;
    if (er < 6e-4 || el < 6e-4) {
        for (int j = 0; j < n; ++j) y[j] = x[j];
        return;
    }
    double lgain = 1.0 / std::sqrt(el), rgain = 1.0 / std::sqrt(er);
    for (int j = 0; j < n; ++j) {
        double l = mid * x[j], r = y[j];
        x[j] = lgain * (l - r);
        y[j] = rgain * (l + r);
    }
}

static unsigned quant_band_stereo(CeltCtx& ctx, double* x, double* y, int n,
                                  int b, int B, double* lowband, int LM,
                                  double* lowband_out, double* scratch,
                                  int fill) {
    if (n == 1) return quant_band_n1(ctx, x, y, lowband_out);
    int orig_fill = fill;
    Theta t = compute_theta(ctx, n, b, B, B, LM, 1, fill);
    b = t.b; fill = t.fill;
    double mid = (1.0 / 32768) * t.imid, side = (1.0 / 32768) * t.iside;
    unsigned cm;
    if (n == 2) {
        int mbits = b, sbits = 0;
        if (t.itheta != 0 && t.itheta != 16384) sbits = 1 << 3;
        mbits -= sbits;
        int c = t.itheta > 8192;
        ctx.remaining_bits -= t.qalloc + sbits;
        double* x2 = c ? y : x;
        double* y2 = c ? x : y;
        int sign = 0;
        if (sbits) sign = (int)ctx.rd->bits(1);
        sign = 1 - 2 * sign;
        cm = quant_band(ctx, x2, n, mbits, B, lowband, LM, lowband_out, 1.0,
                        scratch, orig_fill);
        y2[0] = -sign * x2[1];
        y2[1] = sign * x2[0];
        x[0] = mid * x[0];
        x[1] = mid * x[1];
        y[0] = side * y[0];
        y[1] = side * y[1];
        double tmp = x[0];
        x[0] = tmp - y[0];
        y[0] = tmp + y[0];
        tmp = x[1];
        x[1] = tmp - y[1];
        y[1] = tmp + y[1];
    } else {
        int half = tdiv(b - t.delta, 2);
        int mbits = b < half ? b : half;
        if (mbits < 0) mbits = 0;
        int sbits = b - mbits;
        ctx.remaining_bits -= t.qalloc;
        int rebalance = ctx.remaining_bits;
        if (mbits >= sbits) {
            cm = quant_band(ctx, x, n, mbits, B, lowband, LM, lowband_out, 1.0,
                            scratch, fill);
            rebalance = mbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << 3 && t.itheta != 0) sbits += rebalance - (3 << 3);
            cm |= quant_band(ctx, y, n, sbits, B, nullptr, LM, nullptr, side,
                             nullptr, fill >> B);
        } else {
            cm = quant_band(ctx, y, n, sbits, B, nullptr, LM, nullptr, side,
                            nullptr, fill >> B);
            rebalance = sbits - (rebalance - ctx.remaining_bits);
            if (rebalance > 3 << 3 && t.itheta != 16384) mbits += rebalance - (3 << 3);
            cm |= quant_band(ctx, x, n, mbits, B, lowband, LM, lowband_out, 1.0,
                             scratch, fill);
        }
    }
    if (n != 2) stereo_merge(x, y, mid, n);
    if (t.inv)
        for (int j = 0; j < n; ++j) y[j] = -y[j];
    return cm;
}

struct Alloc {
    int coded, balance, intensity, dual;
    int bits[21], ebits[21], prio[21];
};

static void interp_bits2pulses(const OpusTabs& T, OpusRange& rd, int start,
                               int end, int skip_start, const int* bits1,
                               const int* bits2, const int* thresh,
                               const int* cap, int total, int skip_rsv,
                               int intensity_rsv, int dual_rsv, int C, int LM,
                               Alloc& a) {
    const int32_t* EB = T[T_EBANDS];
    int alloc_floor = C << 3, stereo = C > 1, log_m = LM << 3;
    int lo = 0, hi = 1 << 6;
    for (int it = 0; it < 6; ++it) {
        int mid = (lo + hi) >> 1, psum = 0, done = 0;
        for (int j = end - 1; j >= start; --j) {
            int tmp = bits1[j] + ((mid * bits2[j]) >> 6);
            if (tmp >= thresh[j] || done) {
                done = 1;
                psum += tmp < cap[j] ? tmp : cap[j];
            } else if (tmp >= alloc_floor) psum += alloc_floor;
        }
        if (psum > total) hi = mid;
        else lo = mid;
    }
    int psum = 0, done = 0;
    int* bits = a.bits;
    for (int j = 0; j < 21; ++j) bits[j] = a.ebits[j] = a.prio[j] = 0;
    for (int j = end - 1; j >= start; --j) {
        int tmp = bits1[j] + ((lo * bits2[j]) >> 6);
        if (tmp < thresh[j] && !done) tmp = tmp >= alloc_floor ? alloc_floor : 0;
        else done = 1;
        tmp = tmp < cap[j] ? tmp : cap[j];
        bits[j] = tmp;
        psum += tmp;
    }
    int coded = end;
    while (true) {
        int j = coded - 1;
        if (j <= skip_start) {
            total += skip_rsv;
            break;
        }
        int left = total - psum;
        int percoeff = left / (EB[coded] - EB[start]);
        left -= (EB[coded] - EB[start]) * percoeff;
        int rem = left - (EB[j] - EB[start]);
        if (rem < 0) rem = 0;
        int band_width = EB[coded] - EB[j];
        int band_bits = bits[j] + percoeff * band_width + rem;
        int need = thresh[j] > alloc_floor + (1 << 3) ? thresh[j] : alloc_floor + (1 << 3);
        if (band_bits >= need) {
            if (rd.bit_logp(1)) break;
            psum += 1 << 3;
            band_bits -= 1 << 3;
        }
        psum -= bits[j] + intensity_rsv;
        if (intensity_rsv > 0) intensity_rsv = T[T_LOG2_FRAC][j - start];
        psum += intensity_rsv;
        if (band_bits >= alloc_floor) {
            psum += alloc_floor;
            bits[j] = alloc_floor;
        } else bits[j] = 0;
        coded--;
    }
    int intensity = intensity_rsv > 0
        ? start + (int)rd.uint((uint32_t)(coded + 1 - start)) : 0;
    if (intensity <= start) {
        total += dual_rsv;
        dual_rsv = 0;
    }
    int dual = dual_rsv > 0 ? rd.bit_logp(1) : 0;
    int left = total - psum;
    int percoeff = left / (EB[coded] - EB[start]);
    left -= (EB[coded] - EB[start]) * percoeff;
    for (int j = start; j < coded; ++j) bits[j] += percoeff * (EB[j + 1] - EB[j]);
    for (int j = start; j < coded; ++j) {
        int tmp = left < EB[j + 1] - EB[j] ? left : EB[j + 1] - EB[j];
        bits[j] += tmp;
        left -= tmp;
    }
    int balance = 0, j = start;
    for (; j < coded; ++j) {
        int n0 = EB[j + 1] - EB[j], n = n0 << LM, bit = bits[j] + balance;
        int excess;
        if (n > 1) {
            excess = bit - cap[j] > 0 ? bit - cap[j] : 0;
            bits[j] = bit - excess;
            int den = C * n + ((C == 2 && n > 2 && !dual && j < intensity) ? 1 : 0);
            int nclogn = den * (T[T_LOGN][j] + log_m);
            int offset = (nclogn >> 1) - den * 21;
            if (n == 2) offset += (den << 3) >> 2;
            if (bits[j] + offset < (den * 2) << 3) offset += nclogn >> 2;
            else if (bits[j] + offset < (den * 3) << 3) offset += nclogn >> 3;
            int e = bits[j] + offset + (den << 2);
            if (e < 0) e = 0;
            e = (e / den) >> 3;
            if (C * e > (bits[j] >> 3)) e = bits[j] >> stereo >> 3;
            if (e > 8) e = 8;
            a.ebits[j] = e;
            a.prio[j] = e * (den << 3) >= bits[j] + offset;
            bits[j] -= (C * e) << 3;
        } else {
            excess = bit - (C << 3) > 0 ? bit - (C << 3) : 0;
            bits[j] = bit - excess;
            a.ebits[j] = 0;
            a.prio[j] = 1;
        }
        if (excess > 0) {
            int extra_fine = excess >> (stereo + 3);
            if (extra_fine > 8 - a.ebits[j]) extra_fine = 8 - a.ebits[j];
            a.ebits[j] += extra_fine;
            int extra_bits = (extra_fine * C) << 3;
            a.prio[j] = extra_bits >= excess - balance;
            excess -= extra_bits;
        }
        balance = excess;
    }
    for (; j < end; ++j) {
        a.ebits[j] = bits[j] >> stereo >> 3;
        bits[j] = 0;
        a.prio[j] = a.ebits[j] < 1;
    }
    a.coded = coded;
    a.balance = balance;
    a.intensity = intensity;
    a.dual = dual;
}

static void compute_allocation(const OpusTabs& T, OpusRange& rd, int start,
                               int end, const int* offsets, const int* cap,
                               int trim, int total, int C, int LM, Alloc& a) {
    const int32_t* EB = T[T_EBANDS];
    const int32_t* AV = T[T_ALLOC_VECTORS];
    if (total < 0) total = 0;
    int skip_start = start;
    int skip_rsv = total >= 1 << 3 ? 1 << 3 : 0;
    total -= skip_rsv;
    int intensity_rsv = 0, dual_rsv = 0;
    if (C == 2) {
        intensity_rsv = T[T_LOG2_FRAC][end - start];
        if (intensity_rsv > total) intensity_rsv = 0;
        else {
            total -= intensity_rsv;
            dual_rsv = total >= 1 << 3 ? 1 << 3 : 0;
            total -= dual_rsv;
        }
    }
    int thresh[21] = {0}, trim_offset[21] = {0}, bits1[21] = {0},
        bits2[21] = {0};
    for (int j = start; j < end; ++j) {
        int n = EB[j + 1] - EB[j];
        int t = (3 * n << LM << 3) >> 4;
        thresh[j] = (C << 3) > t ? (C << 3) : t;
        trim_offset[j] = (C * n * (trim - 5 - LM) * (end - j - 1)
                          * (1 << (LM + 3))) >> 6;
        if (n << LM == 1) trim_offset[j] -= C << 3;
    }
    int lo = 1, hi = 10;
    do {
        int done = 0, psum = 0, mid = (lo + hi) >> 1;
        for (int j = end - 1; j >= start; --j) {
            int n = EB[j + 1] - EB[j];
            int bitsj = (C * n * AV[mid * 21 + j] << LM) >> 2;
            if (bitsj > 0) {
                bitsj += trim_offset[j];
                if (bitsj < 0) bitsj = 0;
            }
            bitsj += offsets[j];
            if (bitsj >= thresh[j] || done) {
                done = 1;
                psum += bitsj < cap[j] ? bitsj : cap[j];
            } else if (bitsj >= C << 3) psum += C << 3;
        }
        if (psum > total) hi = mid - 1;
        else lo = mid + 1;
    } while (lo <= hi);
    hi = lo--;
    for (int j = start; j < end; ++j) {
        int n = EB[j + 1] - EB[j];
        int b1 = (C * n * AV[lo * 21 + j] << LM) >> 2;
        int b2 = hi >= 11 ? cap[j] : (C * n * AV[hi * 21 + j] << LM) >> 2;
        if (b1 > 0) { b1 += trim_offset[j]; if (b1 < 0) b1 = 0; }
        if (b2 > 0) { b2 += trim_offset[j]; if (b2 < 0) b2 = 0; }
        if (lo > 0) b1 += offsets[j];
        b2 += offsets[j];
        if (offsets[j] > 0) skip_start = j;
        b2 = b2 - b1 > 0 ? b2 - b1 : 0;
        bits1[j] = b1;
        bits2[j] = b2;
    }
    interp_bits2pulses(T, rd, start, end, skip_start, bits1, bits2, thresh,
                       cap, total, skip_rsv, intensity_rsv, dual_rsv, C, LM, a);
}

static void quant_all_bands(CeltCtx& ctx, int start, int end, double* X,
                            double* Y, const int* pulses, int short_blocks,
                            int dual, const int* tf_res, int total_bits,
                            int balance, int LM, int coded,
                            unsigned char* masks) {
    const int32_t* EB = ctx.eb;
    OpusRange& rd = *ctx.rd;
    int M = 1 << LM, B = short_blocks ? M : 1, C = Y ? 2 : 1;
    int norm_offset = M * EB[start];
    int nlen = M * EB[CELT_NB - 1] - norm_offset;
    std::vector<double> norm((size_t)nlen + 1, 0.0), norm2((size_t)nlen + 1, 0.0);
    std::vector<double> scratch_buf((size_t)(M * (EB[CELT_NB] - EB[CELT_NB - 1])), 0.0);
    int lowband_offset = 0, update_lowband = 1;
    for (int i = start; i < end; ++i) {
        ctx.i = i;
        int last = i == end - 1;
        int xo = M * EB[i];
        int n = M * EB[i + 1] - M * EB[i];
        int tell = (int)rd.tell_frac();
        if (i != start) balance -= tell;
        int remaining = total_bits - tell - 1;
        ctx.remaining_bits = remaining;
        int b = 0;
        if (i <= coded - 1) {
            int d = coded - i < 3 ? coded - i : 3;
            int curr_balance = tdiv(balance, d);
            int v = pulses[i] + curr_balance;
            if (remaining + 1 < v) v = remaining + 1;
            if (16383 < v) v = 16383;
            b = v > 0 ? v : 0;
        }
        if ((M * EB[i] - n >= M * EB[start] || i == start + 1)
            && (update_lowband || lowband_offset == 0))
            lowband_offset = i;
        if (i == start + 1) {
            int n1 = M * (EB[start + 1] - EB[start]);
            int n2 = M * (EB[start + 2] - EB[start + 1]);
            for (int k = 0; k < n2 - n1; ++k) norm[(size_t)(n1 + k)] = norm[(size_t)(2 * n1 - n2 + k)];
            if (dual)
                for (int k = 0; k < n2 - n1; ++k) norm2[(size_t)(n1 + k)] = norm2[(size_t)(2 * n1 - n2 + k)];
        }
        int tf_change = tf_res[i];
        ctx.tf_change = tf_change;
        double* scratch = last ? nullptr : scratch_buf.data();
        int effective_lowband = -1;
        unsigned x_cm, y_cm;
        if (lowband_offset != 0 && (ctx.spread != 3 || B > 1 || tf_change < 0)) {
            effective_lowband = M * EB[lowband_offset] - norm_offset - n;
            if (effective_lowband < 0) effective_lowband = 0;
            int fold_start = lowband_offset;
            while (M * EB[--fold_start] > effective_lowband + norm_offset) {}
            int fold_end = lowband_offset - 1;
            while (++fold_end < i && M * EB[fold_end] < effective_lowband + norm_offset + n) {}
            x_cm = y_cm = 0;
            int fi = fold_start;
            do {
                x_cm |= masks[fi * C];
                y_cm |= masks[fi * C + C - 1];
            } while (++fi < fold_end);
        } else {
            x_cm = y_cm = (1u << B) - 1;
        }
        if (dual && i == ctx.intensity) {
            dual = 0;
            for (int j = 0; j < M * EB[i] - norm_offset; ++j)
                norm[(size_t)j] = 0.5 * (norm[(size_t)j] + norm2[(size_t)j]);
        }
        int out_off = M * EB[i] - norm_offset;
        double* lb1 = effective_lowband != -1 ? norm.data() + effective_lowband : nullptr;
        double* lb2 = effective_lowband != -1 ? norm2.data() + effective_lowband : nullptr;
        if (dual) {
            x_cm = quant_band(ctx, X + xo, n, b / 2, B, lb1, LM,
                              last ? nullptr : norm.data() + out_off, 1.0,
                              scratch, (int)x_cm);
            y_cm = quant_band(ctx, Y + xo, n, b / 2, B, lb2, LM,
                              last ? nullptr : norm2.data() + out_off, 1.0,
                              scratch, (int)y_cm);
        } else {
            if (Y)
                x_cm = quant_band_stereo(ctx, X + xo, Y + xo, n, b, B, lb1, LM,
                                         last ? nullptr : norm.data() + out_off,
                                         scratch, (int)(x_cm | y_cm));
            else
                x_cm = quant_band(ctx, X + xo, n, b, B, lb1, LM,
                                  last ? nullptr : norm.data() + out_off, 1.0,
                                  scratch, (int)(x_cm | y_cm));
            y_cm = x_cm;
        }
        masks[i * C] = (unsigned char)x_cm;
        masks[i * C + C - 1] = (unsigned char)y_cm;
        balance += pulses[i] + tell;
        update_lowband = b > (n << 3);
    }
}

static void anti_collapse(const int32_t* EB, double* const* xs,
                          const unsigned char* masks, int LM, int C,
                          int start, int end, const double* old,
                          const double* log1, const double* log2,
                          const int* pulses, uint32_t seed) {
    const double sqrt2 = (double)1.41421356f;
    for (int i = start; i < end; ++i) {
        int n0 = EB[i + 1] - EB[i];
        int depth = ((1 + pulses[i]) / n0) >> LM;
        double thresh = 0.5 * celt_exp2(-0.125 * depth);
        double sqrt_1 = 1.0 / std::sqrt((double)(n0 << LM));
        for (int c = 0; c < C; ++c) {
            double prev1 = log1[c * 21 + i], prev2 = log2[c * 21 + i];
            if (C == 1) {
                if (log1[21 + i] > prev1) prev1 = log1[21 + i];
                if (log2[21 + i] > prev2) prev2 = log2[21 + i];
            }
            double mn = prev1 < prev2 ? prev1 : prev2;
            double ediff = old[c * 21 + i] - mn;
            if (ediff < 0.0) ediff = 0.0;
            double r = 2.0 * celt_exp2(-ediff);
            if (LM == 3) r *= sqrt2;
            if (thresh < r) r = thresh;
            r = r * sqrt_1;
            double* x = xs[c] + (EB[i] << LM);
            int renorm = 0;
            for (int k = 0; k < 1 << LM; ++k) {
                if (!(masks[i * C + c] & (1 << k))) {
                    for (int j = 0; j < n0; ++j) {
                        seed = lcg_rand(seed);
                        x[(j << LM) + k] = (seed & 0x8000) ? r : -r;
                    }
                    renorm = 1;
                }
            }
            if (renorm) renormalise(x, n0 << LM, 1.0);
        }
    }
}

// One CELT frame's symbols into MDCT coefficients: frame_spectrum of
// audio/celt.py. energy [4][42]: old, log, log2, background; rng: the
// folding seed; out ints: transient, pitch, tapset; gain: the post-filter's.
// loss_count: the frames concealed before this one (the background
// energy's step).
static int celt_spectrum(OpusRange& rd, const OpusTabs& T, int n, int C,
                         int start, int end, int disable_inv, int loss_count,
                         double* energy, int64_t* rng_io, double* freq,
                         int64_t* ints, double* gain_out) {
    const int32_t* EB = T[T_EBANDS];
    int LM = n == 120 ? 0 : n == 240 ? 1 : n == 480 ? 2 : n == 960 ? 3 : -1;
    if (LM < 0 || C < 1 || C > 2 || start < 0 || end > 21 || start >= end)
        return -1;
    int M = 1 << LM;
    double* old = energy;
    double* log1 = energy + 42;
    double* log2 = energy + 84;
    double* bg = energy + 126;
    if (C == 1)
        for (int i = 0; i < 21; ++i) if (old[21 + i] > old[i]) old[i] = old[21 + i];
    int64_t length = rd.storage;
    int64_t total_bits = length * 8;
    int64_t tell = rd.tell();
    int silence;
    if (tell >= total_bits) silence = 1;
    else if (tell == 1) silence = rd.bit_logp(15);
    else silence = 0;
    if (silence) {
        tell = length * 8;
        rd.nbits_total += tell - rd.tell();
    }
    double pf_gain = 0.0;
    int pf_pitch = 0, pf_tapset = 0;
    if (start == 0 && tell + 16 <= total_bits) {
        if (rd.bit_logp(1)) {
            int octave = (int)rd.uint(6);
            pf_pitch = (16 << octave) + (int)rd.bits(4 + octave) - 1;
            int qg = (int)rd.bits(3);
            if (rd.tell() + 2 <= total_bits)
                pf_tapset = rd.icdf(T[T_TAPSET_ICDF], 2);
            pf_gain = 0.09375 * (qg + 1);
        }
        tell = rd.tell();
    }
    int transient = 0;
    if (LM > 0 && tell + 3 <= total_bits) {
        transient = rd.bit_logp(3);
        tell = rd.tell();
    }
    int short_blocks = transient ? M : 0;
    int intra = tell + 3 <= total_bits ? rd.bit_logp(3) : 0;
    // coarse energy
    {
        const int32_t* prob = T[T_E_PROB_MODEL] + (LM * 2 + intra) * 42;
        double coef = intra ? 0.0 : CELT_PRED_COEF[LM];
        double beta = intra ? CELT_BETA_INTRA : CELT_BETA_COEF[LM];
        double prev[2] = {0.0, 0.0};
        int64_t budget = rd.storage * 8;
        for (int i = start; i < end; ++i)
            for (int c = 0; c < C; ++c) {
                int64_t t = rd.tell();
                int qi;
                if (budget - t >= 15) {
                    int pi = 2 * (i < 20 ? i : 20);
                    qi = laplace_decode(rd, prob[pi] << 7, prob[pi + 1] << 6);
                } else if (budget - t >= 2) {
                    qi = rd.icdf(T[T_SMALL_ENERGY_ICDF], 2);
                    qi = (qi >> 1) ^ -(qi & 1);
                } else if (budget - t >= 1) {
                    qi = -rd.bit_logp(1);
                } else qi = -1;
                double q = (double)qi;
                int k = i + c * 21;
                if (old[k] < -9.0) old[k] = -9.0;
                double tmp = coef * old[k] + prev[c] + q;
                old[k] = tmp;
                prev[c] = prev[c] + q - beta * q;
            }
    }
    // TF
    int tf_res[21] = {0};
    {
        int64_t budget = rd.storage * 8;
        int64_t t = rd.tell();
        int logp = transient ? 2 : 4;
        int tf_select_rsv = LM > 0 && t + logp + 1 <= budget;
        budget -= tf_select_rsv;
        int tf_changed = 0, curr = 0;
        for (int i = start; i < end; ++i) {
            if (t + logp <= budget) {
                curr ^= rd.bit_logp(logp);
                t = rd.tell();
                tf_changed |= curr;
            }
            tf_res[i] = curr;
            logp = transient ? 4 : 5;
        }
        const int32_t* tab = T[T_TF_SELECT] + 8 * LM;
        int tf_select = 0;
        if (tf_select_rsv && tab[4 * transient + tf_changed]
                != tab[4 * transient + 2 + tf_changed])
            tf_select = rd.bit_logp(1);
        for (int i = start; i < end; ++i)
            tf_res[i] = tab[4 * transient + 2 * tf_select + tf_res[i]];
    }
    tell = rd.tell();
    int spread = 2;
    if (tell + 4 <= total_bits) spread = rd.icdf(T[T_SPREAD_ICDF], 5);
    int cap[21], offsets[21] = {0};
    for (int i = 0; i < 21; ++i) {
        int nn = (EB[i + 1] - EB[i]) << LM;
        cap[i] = ((T[T_CACHE_CAPS][21 * (2 * LM + C - 1) + i] + 64) * C * nn) >> 2;
    }
    int dynalloc_logp = 6;
    total_bits <<= 3;
    tell = rd.tell_frac();
    for (int i = start; i < end; ++i) {
        int width = (C * (EB[i + 1] - EB[i])) << LM;
        int quanta = width << 3;
        int q2 = (6 << 3) > width ? (6 << 3) : width;
        if (q2 < quanta) quanta = q2;
        int loop_logp = dynalloc_logp, boost = 0;
        while (tell + (loop_logp << 3) < total_bits && boost < cap[i]) {
            int flag = rd.bit_logp(loop_logp);
            tell = rd.tell_frac();
            if (!flag) break;
            boost += quanta;
            total_bits -= quanta;
            loop_logp = 1;
        }
        offsets[i] = boost;
        if (boost > 0) dynalloc_logp = dynalloc_logp - 1 > 2 ? dynalloc_logp - 1 : 2;
    }
    int trim = tell + (6 << 3) <= total_bits ? rd.icdf(T[T_TRIM_ICDF], 7) : 5;
    int bits = (int)(((length * 8) << 3) - rd.tell_frac() - 1);
    int ac_rsv = (transient && LM >= 2 && bits >= (LM + 2) << 3) ? 1 << 3 : 0;
    bits -= ac_rsv;
    Alloc a;
    compute_allocation(T, rd, start, end, offsets, cap, trim, bits, C, LM, a);
    for (int i = start; i < end; ++i) {
        if (a.ebits[i] <= 0) continue;
        for (int c = 0; c < C; ++c) {
            int q2 = (int)rd.bits(a.ebits[i]);
            double offset = (q2 + 0.5) * (double)(1 << (14 - a.ebits[i]))
                * (1.0 / 16384) - 0.5;
            old[i + c * 21] += offset;
        }
    }
    std::vector<double> X((size_t)n, 0.0), Y((size_t)n, 0.0);
    std::vector<unsigned char> masks(2 * 21, 0);
    CeltCtx ctx;
    ctx.rd = &rd;
    ctx.T = T;
    ctx.eb = EB;
    ctx.intensity = a.intensity;
    ctx.spread = spread;
    ctx.disable_inv = disable_inv;
    ctx.seed = (uint32_t)rng_io[0];
    ctx.remaining_bits = 0;
    ctx.tf_change = 0;
    quant_all_bands(ctx, start, end, X.data(), C == 2 ? Y.data() : nullptr,
                    a.bits, short_blocks, a.dual, tf_res,
                    (int)(length * (8 << 3) - ac_rsv), a.balance, LM, a.coded,
                    masks.data());
    int ac_on = ac_rsv > 0 ? (int)rd.bits(1) : 0;
    {
        int bits_left = (int)(length * 8 - rd.tell());
        for (int p = 0; p < 2; ++p)
            for (int i = start; i < end && bits_left >= C; ++i) {
                if (a.ebits[i] >= 8 || a.prio[i] != p) continue;
                for (int c = 0; c < C; ++c) {
                    int q2 = (int)rd.bits(1);
                    double offset = (q2 - 0.5) * (double)(1 << (14 - a.ebits[i] - 1))
                        * (1.0 / 16384);
                    old[i + c * 21] += offset;
                    bits_left--;
                }
            }
    }
    double* xs[2] = {X.data(), Y.data()};
    if (ac_on)
        anti_collapse(EB, xs, masks.data(), LM, C, start, end, old, log1,
                      log2, a.bits, ctx.seed);
    if (silence)
        for (int i = 0; i < C * 21; ++i) old[i] = -28.0;
    int eff_end = end < 21 ? end : 21;
    for (int c = 0; c < C; ++c) {
        double* f = freq + (size_t)c * n;
        for (int j = 0; j < n; ++j) f[j] = 0.0;
        if (silence) continue;
        for (int i = start; i < eff_end; ++i) {
            double lg = old[c * 21 + i] + CELT_E_MEANS[i];
            double g = celt_exp2(32.0 < lg ? 32.0 : lg);
            for (int j = M * EB[i]; j < M * EB[i + 1]; ++j) f[j] = xs[c][j] * g;
        }
    }
    if (C == 1)
        for (int i = 0; i < 21; ++i) old[21 + i] = old[i];
    if (!transient) {
        for (int i = 0; i < 42; ++i) {
            log2[i] = log1[i];
            log1[i] = old[i];
        }
        double inc = loss_count < 10 ? M * (double)0.001f : 1.0;
        for (int i = 0; i < 42; ++i) {
            double v = bg[i] + inc;
            bg[i] = v < old[i] ? v : old[i];
        }
    } else {
        for (int i = 0; i < 42; ++i) if (old[i] < log1[i]) log1[i] = old[i];
    }
    for (int c = 0; c < 2; ++c)
        for (int i = 0; i < 21; ++i)
            if (i < start || i >= end) {
                old[c * 21 + i] = 0.0;
                log1[c * 21 + i] = log2[c * 21 + i] = -28.0;
            }
    rng_io[0] = rd.rng;
    ints[0] = transient;
    ints[1] = pf_pitch;
    ints[2] = pf_tapset;
    ints[3] = silence;
    gain_out[0] = pf_gain;
    return rd.error == 2 ? -1 : 0;
}

static void comb_filter(double* x, int t0, int t1, int n, double g0,
                        double g1, int tap0, int tap1, const double* w) {
    static const double gains[3][3] = {
        {(double)0.3066406250f, (double)0.2170410156f, (double)0.1296386719f},
        {(double)0.4638671875f, (double)0.2680664062f, 0.0},
        {(double)0.7998046875f, (double)0.1000976562f, 0.0}};
    if (g0 == 0 && g1 == 0) return;
    if (t0 < 15) t0 = 15;
    if (t1 < 15) t1 = 15;
    double g00 = g0 * gains[tap0][0], g01 = g0 * gains[tap0][1],
           g02 = g0 * gains[tap0][2];
    double g10 = g1 * gains[tap1][0], g11 = g1 * gains[tap1][1],
           g12 = g1 * gains[tap1][2];
    int overlap = 120;
    if (g0 == g1 && t0 == t1 && tap0 == tap1) overlap = 0;
    int i = 0;
    for (; i < overlap; ++i) {
        double f = w[i] * w[i];
        double* p = x + i;
        *p = *p + ((1.0 - f) * g00) * p[-t0]
            + ((1.0 - f) * g01) * (p[-t0 + 1] + p[-t0 - 1])
            + ((1.0 - f) * g02) * (p[-t0 + 2] + p[-t0 - 2])
            + (f * g10) * p[-t1]
            + (f * g11) * (p[-t1 + 1] + p[-t1 - 1])
            + (f * g12) * (p[-t1 + 2] + p[-t1 - 2]);
    }
    if (g1 == 0) return;
    for (; i < n; ++i) {
        double* p = x + i;
        *p = *p + g10 * p[-t1] + g11 * (p[-t1 + 1] + p[-t1 - 1])
            + g12 * (p[-t1 + 2] + p[-t1 - 2]);
    }
}

// The pitch post-filter and de-emphasis of one frame: postfilter_deemphasis
// of audio/celt.py. hist [channels][hist_len]: the post-filtered past
// (hist_len - 60 samples, then the IMDCT's folded tail, untouched); out
// [channels][n]; pf: period, gain, tapset and their last values; window:
// the 120-sample window; pcm [n][channels].
static void celt_postfilter(double* hist, int64_t hist_len, const double* out,
                            int channels, int n, double* pf, double* preemph,
                            int pitch, double gain, int tapset, double* pcm,
                            const double* window) {
    const int64_t h = hist_len - 60;
    const int LM = n == 120 ? 0 : n == 240 ? 1 : n == 480 ? 2 : 3;
    const double preemph_coef = (double)0.85000610f;
    std::vector<double> buf((size_t)(h + n));
    if (pf[0] < 15) pf[0] = 15;
    if (pf[3] < 15) pf[3] = 15;
    for (int c = 0; c < channels; ++c) {
        double* hc = hist + (size_t)c * hist_len;
        for (int64_t k = 0; k < h; ++k) buf[(size_t)k] = hc[k];
        for (int k = 0; k < n; ++k) buf[(size_t)(h + k)] = out[(size_t)c * n + k];
        comb_filter(buf.data() + h, (int)pf[3], (int)pf[0], 120, pf[4], pf[1],
                    (int)pf[5], (int)pf[2], window);
        if (LM != 0)
            comb_filter(buf.data() + h + 120, (int)pf[0], pitch, n - 120,
                        pf[1], gain, (int)pf[2], tapset, window);
        for (int64_t k = 0; k < h; ++k) hc[k] = buf[(size_t)(n + k)];
        double m = preemph[c];
        for (int j = 0; j < n; ++j) {
            double tmp = buf[(size_t)(h + j)] + (double)1e-30f + m;
            m = preemph_coef * tmp;
            pcm[(size_t)j * channels + c] = tmp * (1.0 / 32768);
        }
        preemph[c] = m;
    }
    for (int k = 0; k < 3; ++k) pf[3 + k] = pf[k];
    pf[0] = pitch;
    pf[1] = gain;
    pf[2] = tapset;
    if (LM != 0)
        for (int k = 0; k < 3; ++k) pf[3 + k] = pf[k];
}

// The synthesis tables of audio/celt.py synth_blob: the radix-3 and -5 DFT
// constants, the window, and per FFT size (60, 120, 240, 480) the MDCT's
// rotation and each Stockham stage's twiddles.
struct SynthTabs {
    static constexpr int SIZES[4] = {60, 120, 240, 480};
    const double *w3r, *w3i, *w5r, *w5i, *window;
    const double* trig[4];
    const double* tw[4][8][2];
    int radix[4][8], nstages[4];

    explicit SynthTabs(const double* b) {
        w3r = b; w3i = b + 3; w5r = b + 6; w5i = b + 11; window = b + 16;
        const double* p = b + 136;
        for (int s = 0; s < 4; ++s) {
            int n4 = SIZES[s], n = n4, k = 0;
            trig[s] = p;
            p += 2 * n4;
            for (int r : {2, 3, 5})
                while (n % r == 0) {
                    radix[s][k] = r;
                    tw[s][k][0] = p; p += n4;
                    tw[s][k][1] = p; p += n4;
                    n /= r;
                    ++k;
                }
            nstages[s] = k;
        }
    }
};
constexpr int SynthTabs::SIZES[4];

// The forward, unscaled DFT of size SIZES[s] (celt.fft: self-sorting
// Stockham, the same operations in the same order). re/im hold the input;
// the output is left in the buffer returned (re or tr).
static void opus_fft(const SynthTabs& S, int s, double*& re, double*& im,
                     double*& tr, double*& ti) {
    const int n = SynthTabs::SIZES[s];
    int ns = 1;
    for (int st = 0; st < S.nstages[s]; ++st) {
        const int R = S.radix[s][st], m = n / R;
        const double* twr = S.tw[s][st][0];
        const double* twi = S.tw[s][st][1];
        const double* cr = R == 3 ? S.w3r : S.w5r;
        const double* ci = R == 3 ? S.w3i : S.w5i;
        for (int j = 0; j < m; ++j) {
            double vr[5], vi[5];
            vr[0] = re[j];
            vi[0] = im[j];
            for (int q = 1; q < R; ++q) {
                double a = re[q * m + j], b = im[q * m + j];
                vr[q] = a * twr[q * m + j] - b * twi[q * m + j];
                vi[q] = a * twi[q * m + j] + b * twr[q * m + j];
            }
            const int at = (j / ns) * ns * R + (j % ns);
            if (R == 2) {
                tr[at] = vr[0] + vr[1];
                ti[at] = vi[0] + vi[1];
                tr[at + ns] = vr[0] - vr[1];
                ti[at + ns] = vi[0] - vi[1];
            } else {
                for (int q = 0; q < R; ++q) {
                    double ar = vr[0], ai = vi[0];
                    for (int t = 1; t < R; ++t) {
                        const int w = (t * q) % R;
                        ar = ar + (vr[t] * cr[w] - vi[t] * ci[w]);
                        ai = ai + (vr[t] * ci[w] + vi[t] * cr[w]);
                    }
                    tr[at + q * ns] = ar;
                    ti[at + q * ns] = ai;
                }
            }
        }
        std::swap(re, tr);
        std::swap(im, ti);
        ns *= R;
    }
}

// One channel's synthesis: celt.synthesize. freq [n], tail [60] (replaced
// by the next tail), out [n].
static void celt_synthesize(const SynthTabs& S, const double* freq, int n,
                            int transient, double* tail, double* out) {
    const int B = transient ? n / 120 : 1, nb = n / B, n4 = nb / 2;
    int s = 0;
    while (SynthTabs::SIZES[s] != n4) ++s;
    const double* ta = S.trig[s];
    const double* tb = S.trig[s] + n4;
    const double* w = S.window;
    std::vector<double> buf((size_t)(n + 60)), a((size_t)n4), b((size_t)n4),
        c((size_t)n4), d((size_t)n4);
    for (int k = 0; k < 60; ++k) buf[(size_t)k] = tail[k];
    for (int blk = 0; blk < B; ++blk) {
        double *re = a.data(), *im = b.data(), *tr = c.data(), *ti = d.data();
        for (int k = 0; k < n4; ++k) {
            const double x1 = freq[blk + (2 * k) * B];
            const double x2 = freq[blk + (nb - 1 - 2 * k) * B];
            re[k] = x1 * ta[k] - x2 * tb[k];
            im[k] = x2 * ta[k] + x1 * tb[k];
        }
        opus_fft(S, s, re, im, tr, ti);
        double* y = buf.data() + nb * blk + 60;
        for (int k = 0; k < n4; ++k) {
            y[2 * k] = im[k] * ta[k] + re[k] * tb[k];
            y[nb - 1 - 2 * k] = im[k] * tb[k] - re[k] * ta[k];
        }
        double* seg = buf.data() + nb * blk;
        for (int k = 0; k < 60; ++k) {
            const double x2 = seg[k], x1 = seg[119 - k];
            seg[k] = w[119 - k] * x2 - w[k] * x1;
            seg[119 - k] = w[k] * x2 + w[119 - k] * x1;
        }
    }
    for (int k = 0; k < n; ++k) out[k] = buf[(size_t)k];
    for (int k = 0; k < 60; ++k) tail[k] = buf[(size_t)(n + k)];
}

// One CELT frame, all of celt.decode_frame: the range-coded spectrum
// (celt_spectrum), the synthesis of each of the decoder's CC channels and
// the post-filter with de-emphasis. hist [CC][hist_len]: the post-filtered
// past, then the folded tail; pf and preemph: the filters' state; pcm
// [n][CC]. Returns 0, or -1 on a corrupt frame.
extern "C" int64_t celt_frame(const uint8_t* buf, int64_t* range,
                              const int32_t* blob, const int64_t* off,
                              int n_tables, const double* synth, int n,
                              int C, int CC, int start, int end,
                              int disable_inv, int loss_count, double* energy,
                              int64_t* rng_io, double* pf, double* preemph,
                              double* hist, int64_t hist_len, double* pcm) {
    if (n_tables != OPUS_TABLE_COUNT || CC < 1 || CC > 2) return -1;
    OpusTabs T{blob, off};
    SynthTabs S(synth);
    OpusRange rd;
    rd.load(buf, range);
    std::vector<double> freq((size_t)(2 * n), 0.0);
    int64_t ints[4];
    double gain;
    int got = celt_spectrum(rd, T, n, C, start, end, disable_inv, loss_count,
                            energy, rng_io, freq.data(), ints, &gain);
    rd.store(range);
    if (got < 0) return -1;
    std::vector<double> f((size_t)(CC * n)), out((size_t)(CC * n));
    for (int j = 0; j < n; ++j) {
        if (CC == 2 && C == 1) f[(size_t)j] = f[(size_t)(n + j)] = freq[(size_t)j];
        else if (CC == 1 && C == 2)
            f[(size_t)j] = 0.5 * freq[(size_t)j] + 0.5 * freq[(size_t)(n + j)];
        else
            for (int c = 0; c < CC; ++c) f[(size_t)(c * n + j)] = freq[(size_t)(c * n + j)];
    }
    const int64_t h = hist_len - 60;
    for (int c = 0; c < CC; ++c)
        celt_synthesize(S, f.data() + (size_t)c * n, n, (int)ints[0],
                        hist + (size_t)c * hist_len + h, out.data() + (size_t)c * n);
    celt_postfilter(hist, hist_len, out.data(), CC, n, pf, preemph,
                    (int)ints[1], gain, (int)ints[2], pcm, S.window);
    return 0;
}

// -- SILK (audio/silk.py) ----------------------------------------------------------
// Every value is an int64_t, as Python's integers, wrapped to 32 bits where
// the plain version wraps them (w32), so the two agree bit for bit.

typedef int64_t I;

static inline I w32(I x) { return (I)(int32_t)(uint32_t)(uint64_t)x; }
static inline I i16(I x) { return (I)(int16_t)(uint16_t)(uint64_t)x; }
static inline I smulwb(I a, I b) { return (a * i16(b)) >> 16; }
static inline I smlawb(I a, I b, I c) { return a + ((b * i16(c)) >> 16); }
static inline I smulww(I a, I b) { return w32((a * b) >> 16); }
static inline I smulbb(I a, I b) { return i16(a) * i16(b); }
static inline I smmul(I a, I b) { return (a * b) >> 32; }
static inline I rshift_round(I a, int s) {
    return s == 1 ? (a >> 1) + (a & 1) : ((a >> (s - 1)) + 1) >> 1;
}
static inline I sat16(I x) { return x < -32768 ? -32768 : x > 32767 ? 32767 : x; }
static inline I sat32(I x) {
    return x < -0x80000000LL ? -0x80000000LL : x > 0x7FFFFFFFLL ? 0x7FFFFFFFLL : x;
}
static inline I lshift_sat32(I a, int s) {
    I lo = -0x80000000LL >> s, hi = 0x7FFFFFFFLL >> s;
    return (a < lo ? lo : a > hi ? hi : a) << s;
}
static inline int clz32(I x) {
    uint32_t v = (uint32_t)(uint64_t)x;
    if (!v) return 32;
    int n = 0;
    while (!(v & 0x80000000u)) { v <<= 1; ++n; }
    return n;
}
static inline I stdiv(I a, I b) {
    I q = (a < 0 ? -a : a) / (b < 0 ? -b : b);
    return ((a >= 0) == (b > 0)) ? q : -q;
}
static inline I iabs(I x) { return x < 0 ? -x : x; }
static inline I imin(I a, I b) { return a < b ? a : b; }
static inline I imax(I a, I b) { return a > b ? a : b; }

static I div32_varq(I a32, I b32, int qres) {
    int a_head = clz32(iabs(a32)) - 1;
    I a_nrm = w32(a32 << a_head);
    int b_head = clz32(iabs(b32)) - 1;
    I b_nrm = w32(b32 << b_head);
    I b_inv = stdiv(0x7FFFFFFF >> 2, b_nrm >> 16);
    I result = smulwb(a_nrm, b_inv);
    a_nrm = w32(a_nrm - w32(smmul(b_nrm, result) << 3));
    result = smlawb(result, a_nrm, b_inv);
    int lshift = 29 + a_head - b_head - qres;
    if (lshift < 0) return lshift_sat32(result, -lshift);
    return lshift < 32 ? result >> lshift : 0;
}

static I inverse32_varq(I b32, int qres) {
    int b_head = clz32(iabs(b32)) - 1;
    I b_nrm = w32(b32 << b_head);
    I b_inv = stdiv(0x7FFFFFFF >> 2, b_nrm >> 16);
    I result = w32(b_inv << 16);
    I err = w32(((I)(1 << 29) - smulwb(b_nrm, b_inv)) << 3);
    result = w32(result + smulww(err, b_inv));
    int lshift = 61 - b_head - qres;
    if (lshift <= 0) return lshift_sat32(result, -lshift);
    return lshift < 32 ? result >> lshift : 0;
}

static I log2lin(I in_q7) {
    if (in_q7 < 0) return 0;
    if (in_q7 >= 3967) return 0x7FFFFFFF;
    I out = (I)1 << (in_q7 >> 7);
    I frac = in_q7 & 0x7F;
    I poly = smlawb(frac, smulbb(frac, 128 - frac), -174);
    if (in_q7 < 2048) return out + ((out * poly) >> 7);
    return out + (out >> 7) * poly;
}

static inline I silk_rand(I seed) { return w32(907633515 + seed * 196314165); }

struct NlsfCb {
    int order, step_q16;
    const int32_t *cb1, *wght, *cb1_icdf, *select, *cb2_icdf, *pred, *delta_min;
};

static NlsfCb nlsf_cb(const OpusTabs& T, bool wb) {
    NlsfCb c;
    c.order = wb ? 16 : 10;
    c.step_q16 = wb ? 9830 : 11796;
    c.cb1 = T[wb ? S_NLSF_WB_CB1_Q8 : S_NLSF_NB_MB_CB1_Q8];
    c.wght = T[wb ? S_NLSF_WB_CB1_WGHT_Q9 : S_NLSF_NB_MB_CB1_WGHT_Q9];
    c.cb1_icdf = T[wb ? S_NLSF_WB_CB1_ICDF : S_NLSF_NB_MB_CB1_ICDF];
    c.select = T[wb ? S_NLSF_WB_CB2_SELECT : S_NLSF_NB_MB_CB2_SELECT];
    c.cb2_icdf = T[wb ? S_NLSF_WB_CB2_ICDF : S_NLSF_NB_MB_CB2_ICDF];
    c.pred = T[wb ? S_NLSF_WB_PRED_Q8 : S_NLSF_NB_MB_PRED_Q8];
    c.delta_min = T[wb ? S_NLSF_WB_DELTA_MIN_Q15 : S_NLSF_NB_MB_DELTA_MIN_Q15];
    return c;
}

static void nlsf_unpack(const NlsfCb& cb, int idx, I* ec_ix, I* pred) {
    int sel = idx * cb.order / 2;
    for (int i = 0; i < cb.order; i += 2) {
        int entry = cb.select[sel++];
        ec_ix[i] = ((entry >> 1) & 7) * 9;
        pred[i] = cb.pred[i + (entry & 1) * (cb.order - 1)];
        ec_ix[i + 1] = ((entry >> 5) & 7) * 9;
        pred[i + 1] = cb.pred[i + ((entry >> 4) & 1) * (cb.order - 1) + 1];
    }
}

static void nlsf_stabilize(I* nlsf, const int32_t* dmin, int n) {
    for (int loop = 0; loop < 20; ++loop) {
        I min_diff = nlsf[0] - dmin[0];
        int ii = 0;
        for (int i = 1; i < n; ++i) {
            I diff = nlsf[i] - (nlsf[i - 1] + dmin[i]);
            if (diff < min_diff) { min_diff = diff; ii = i; }
        }
        I diff = (1 << 15) - (nlsf[n - 1] + dmin[n]);
        if (diff < min_diff) { min_diff = diff; ii = n; }
        if (min_diff >= 0) return;
        if (ii == 0) nlsf[0] = dmin[0];
        else if (ii == n) nlsf[n - 1] = (1 << 15) - dmin[n];
        else {
            I min_c = 0;
            for (int k = 0; k < ii; ++k) min_c += dmin[k];
            min_c += dmin[ii] >> 1;
            I max_c = 1 << 15;
            for (int k = n; k > ii; --k) max_c -= dmin[k];
            max_c -= dmin[ii] >> 1;
            I v = rshift_round(nlsf[ii - 1] + nlsf[ii], 1), c;
            if (min_c > max_c) c = v > min_c ? min_c : (v < max_c ? max_c : v);
            else c = v > max_c ? max_c : (v < min_c ? min_c : v);
            c = i16(c);
            nlsf[ii - 1] = c - (dmin[ii] >> 1);
            nlsf[ii] = nlsf[ii - 1] + dmin[ii];
        }
    }
    std::sort(nlsf, nlsf + n);
    nlsf[0] = imax(nlsf[0], dmin[0]);
    for (int i = 1; i < n; ++i) nlsf[i] = imax(nlsf[i], sat16(nlsf[i - 1] + dmin[i]));
    nlsf[n - 1] = imin(nlsf[n - 1], (1 << 15) - dmin[n]);
    for (int i = n - 2; i >= 0; --i) nlsf[i] = imin(nlsf[i], nlsf[i + 1] - dmin[i + 1]);
}

static void nlsf_decode(const NlsfCb& cb, const I* indices, I* nlsf) {
    I ec_ix[16], pred[16], res[16];
    nlsf_unpack(cb, (int)indices[0], ec_ix, pred);
    I out = 0;
    for (int i = cb.order - 1; i >= 0; --i) {
        I pred_q10 = smulbb(out, pred[i]) >> 8;
        out = indices[i + 1] << 10;
        if (out > 0) out -= 102;
        else if (out < 0) out += 102;
        out = smlawb(pred_q10, out, cb.step_q16);
        res[i] = out;
    }
    I base = indices[0] * cb.order;
    for (int i = 0; i < cb.order; ++i) {
        I v = stdiv(res[i] << 14, cb.wght[base + i]) + ((I)cb.cb1[base + i] << 7);
        nlsf[i] = v < 0 ? 0 : v > 32767 ? 32767 : v;
    }
    nlsf_stabilize(nlsf, cb.delta_min, cb.order);
}

static void bwexpander_32(I* ar, int d, I chirp) {
    I minus1 = chirp - 65536;
    for (int i = 0; i < d - 1; ++i) {
        ar[i] = smulww(chirp, ar[i]);
        chirp += rshift_round(chirp * minus1, 16);
    }
    ar[d - 1] = smulww(chirp, ar[d - 1]);
}

static void lpc_fit(I* a_q12, I* a_qin, int qout, int qin, int d) {
    int idx = 0, i = 0;
    for (; i < 10; ++i) {
        I maxabs = 0;
        for (int k = 0; k < d; ++k) {
            I v = iabs(a_qin[k]);
            if (v > maxabs) { maxabs = v; idx = k; }
        }
        maxabs = rshift_round(maxabs, qin - qout);
        if (maxabs > 32767) {
            maxabs = imin(maxabs, 163838);
            I chirp = 65470 - stdiv((maxabs - 32767) << 14, (maxabs * (idx + 1)) >> 2);
            bwexpander_32(a_qin, d, chirp);
        } else break;
    }
    if (i == 10) {
        for (int k = 0; k < d; ++k) {
            a_q12[k] = sat16(rshift_round(a_qin[k], qin - qout));
            a_qin[k] = a_q12[k] << (qin - qout);
        }
    } else {
        for (int k = 0; k < d; ++k) a_q12[k] = i16(rshift_round(a_qin[k], qin - qout));
    }
}

static I inverse_pred_gain_qa(I* a, int order) {
    const I A_LIMIT = 16773022, MIN_INV = 107374;
    I inv_gain = (I)1 << 30;
    for (int k = order - 1; k > 0; --k) {
        if (a[k] > A_LIMIT || a[k] < -A_LIMIT) return 0;
        I rc = w32(-(a[k] << 7));
        I rc_mult1 = ((I)1 << 30) - smmul(rc, rc);
        inv_gain = w32(smmul(inv_gain, rc_mult1) << 2);
        if (inv_gain < MIN_INV) return 0;
        int mult2q = 32 - clz32(iabs(rc_mult1));
        I rc_mult2 = inverse32_varq(rc_mult1, mult2q + 30);
        for (int n = 0; n < (k + 1) >> 1; ++n) {
            I t1 = a[n], t2 = a[k - n - 1];
            __int128 p = (__int128)sat32(t1 - rshift_round(t2 * rc, 31)) * rc_mult2;
            __int128 v = mult2q == 1 ? (p >> 1) + (p & 1) : ((p >> (mult2q - 1)) + 1) >> 1;
            if (v > 0x7FFFFFFF || v < -(__int128)0x80000000LL) return 0;
            a[n] = (I)v;
            p = (__int128)sat32(t2 - rshift_round(t1 * rc, 31)) * rc_mult2;
            v = mult2q == 1 ? (p >> 1) + (p & 1) : ((p >> (mult2q - 1)) + 1) >> 1;
            if (v > 0x7FFFFFFF || v < -(__int128)0x80000000LL) return 0;
            a[k - n - 1] = (I)v;
        }
    }
    if (a[0] > A_LIMIT || a[0] < -A_LIMIT) return 0;
    I rc = w32(-(a[0] << 7));
    I rc_mult1 = ((I)1 << 30) - smmul(rc, rc);
    inv_gain = w32(smmul(inv_gain, rc_mult1) << 2);
    if (inv_gain < MIN_INV) return 0;
    return inv_gain;
}

static I lpc_inverse_pred_gain(const I* a_q12, int order) {
    I sum = 0, a[16];
    for (int k = 0; k < order; ++k) { sum += a_q12[k]; a[k] = a_q12[k] << 12; }
    if (sum >= 4096) return 0;
    return inverse_pred_gain_qa(a, order);
}

static void find_poly(I* out, const I* c, int dd) {
    out[0] = (I)1 << 16;
    out[1] = -c[0];
    for (int k = 1; k < dd; ++k) {
        I f = c[2 * k];
        out[k + 1] = (out[k - 1] << 1) - rshift_round(f * out[k], 16);
        for (int n = k; n > 1; --n) out[n] += out[n - 2] - rshift_round(f * out[n - 1], 16);
        out[1] -= f;
    }
}

static void nlsf2a(const OpusTabs& T, const I* nlsf, int d, I* a_q12) {
    static const int ord16[16] = {0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1};
    static const int ord10[10] = {0, 9, 6, 3, 4, 5, 8, 1, 2, 7};
    const int* ordering = d == 16 ? ord16 : ord10;
    const int32_t* tab = T[S_LSF_COS_TAB_Q12];
    I cos_qa[16], p[9], q[9], a32[16];
    for (int k = 0; k < d; ++k) {
        I f_int = nlsf[k] >> 8, f_frac = nlsf[k] - (f_int << 8);
        I cos_val = tab[f_int], delta = tab[f_int + 1] - cos_val;
        cos_qa[ordering[k]] = rshift_round((cos_val << 8) + delta * f_frac, 4);
    }
    int dd = d >> 1;
    find_poly(p, cos_qa, dd);
    find_poly(q, cos_qa + 1, dd);
    for (int k = 0; k < dd; ++k) {
        I ptmp = p[k + 1] + p[k], qtmp = q[k + 1] - q[k];
        a32[k] = -qtmp - ptmp;
        a32[d - k - 1] = qtmp - ptmp;
    }
    lpc_fit(a_q12, a32, 12, 17, d);
    for (int i = 0; lpc_inverse_pred_gain(a_q12, d) == 0 && i < 16; ++i) {
        bwexpander_32(a32, d, 65536 - ((I)2 << i));
        for (int k = 0; k < d; ++k) a_q12[k] = i16(rshift_round(a32[k], 5));
    }
}

struct SilkResampler {
    int input_delay, fs_in_khz, fs_out_khz, batch, up2_only, copy;
    I inv_ratio;
    I iir[6], fir[8], delay_buf[48];

    void init(const OpusTabs& T, int fs_in, int fs_out) {
        auto rate_id = [](int r) {
            return r == 8000 ? 0 : r == 12000 ? 1 : r == 16000 ? 2 : r == 24000 ? 3 : 4;
        };
        input_delay = T[S_DELAY_MATRIX_DEC][rate_id(fs_in) * 5 + rate_id(fs_out)];
        fs_in_khz = fs_in / 1000;
        fs_out_khz = fs_out / 1000;
        batch = fs_in_khz * 10;
        up2_only = fs_out == 2 * fs_in;
        copy = fs_out == fs_in;
        int up2x = (up2_only || copy) ? 0 : 1;
        I inv = (((I)fs_in << (14 + up2x)) / fs_out) << 2;
        while (smulww(inv, fs_out) < ((I)fs_in << up2x)) inv++;
        inv_ratio = inv;
        for (auto& v : iir) v = 0;
        for (auto& v : fir) v = 0;
        for (auto& v : delay_buf) v = 0;
    }
};

static void up2_hq(const OpusTabs& T, I* s, const I* in, int len, I* out) {
    const int32_t* c0 = T[S_RESAMPLER_UP2_HQ_0];
    const int32_t* c1 = T[S_RESAMPLER_UP2_HQ_1];
    for (int k = 0; k < len; ++k) {
        I in32 = in[k] << 10, y, x, o1, o2;
        y = in32 - s[0]; x = smulwb(y, c0[0]); o1 = s[0] + x; s[0] = in32 + x;
        y = o1 - s[1]; x = smulwb(y, c0[1]); o2 = s[1] + x; s[1] = o1 + x;
        y = o2 - s[2]; x = smlawb(y, y, c0[2]); o1 = s[2] + x; s[2] = o2 + x;
        out[2 * k] = sat16(rshift_round(o1, 10));
        y = in32 - s[3]; x = smulwb(y, c1[0]); o1 = s[3] + x; s[3] = in32 + x;
        y = o1 - s[4]; x = smulwb(y, c1[1]); o2 = s[4] + x; s[4] = o1 + x;
        y = o2 - s[5]; x = smlawb(y, y, c1[2]); o1 = s[5] + x; s[5] = o2 + x;
        out[2 * k + 1] = sat16(rshift_round(o1, 10));
    }
}

static void iir_fir(const OpusTabs& T, SilkResampler& r, const I* in, int len,
                    std::vector<I>& out) {
    const int32_t* fir = T[S_RESAMPLER_FRAC_FIR_12];
    std::vector<I> buf((size_t)(2 * r.batch + 8));
    for (int k = 0; k < 8; ++k) buf[(size_t)k] = r.fir[k];
    int n = 0;
    while (true) {
        n = len < r.batch ? len : r.batch;
        up2_hq(T, r.iir, in, n, buf.data() + 8);
        I max_index = (I)n << 17;
        for (I index = 0; index < max_index; index += r.inv_ratio) {
            I t = smulwb(index & 0xFFFF, 12);
            const I* p = buf.data() + (index >> 16);
            const int32_t* a = fir + 4 * t;
            const int32_t* b = fir + 4 * (11 - t);
            I res = p[0] * a[0] + p[1] * a[1] + p[2] * a[2] + p[3] * a[3]
                + p[4] * b[3] + p[5] * b[2] + p[6] * b[1] + p[7] * b[0];
            out.push_back(sat16(rshift_round(res, 15)));
        }
        in += n;
        len -= n;
        if (len > 0)
            for (int k = 0; k < 8; ++k) buf[(size_t)k] = buf[(size_t)((n << 1) + k)];
        else break;
    }
    for (int k = 0; k < 8; ++k) r.fir[k] = buf[(size_t)((n << 1) + k)];
}

static void silk_resample(const OpusTabs& T, SilkResampler& r, const I* in,
                          int len, std::vector<I>& out) {
    int n_in = r.fs_in_khz - r.input_delay;
    for (int k = 0; k < n_in; ++k) r.delay_buf[r.input_delay + k] = in[k];
    int rest = len - n_in - r.input_delay;
    if (rest < 0) rest = 0;
    if (r.copy) {
        for (int k = 0; k < r.fs_in_khz; ++k) out.push_back(r.delay_buf[k]);
        for (int k = 0; k < rest; ++k) out.push_back(in[n_in + k]);
    } else if (r.up2_only) {
        std::vector<I> t((size_t)(2 * (r.fs_in_khz + rest)));
        up2_hq(T, r.iir, r.delay_buf, r.fs_in_khz, t.data());
        up2_hq(T, r.iir, in + n_in, rest, t.data() + 2 * r.fs_in_khz);
        out.insert(out.end(), t.begin(), t.end());
    } else {
        iir_fir(T, r, r.delay_buf, r.fs_in_khz, out);
        iir_fir(T, r, in + n_in, rest, out);
    }
    for (int k = 0; k < r.input_delay; ++k) r.delay_buf[k] = in[len - r.input_delay + k];
}

struct SilkChannel {
    int fs_khz, fs_api, nb_subfr, frame_length, subfr_length, ltp_mem_length,
        lpc_order;
    I prev_nlsf[16];
    int first_frame_after_reset;
    int lag_low, contour_table;  // OpusTable ids
    int frames_decoded, frames_per_packet, ec_prev_signal_type;
    I ec_prev_lag_index;
    int vad_flags[3], lbrr_flag, lbrr_flags[3];
    SilkResampler resampler;
    bool wb;
    I s_lpc[16];
    I out_buf[480];
    I lag_prev, last_gain_index;
    int prev_signal_type;
    I prev_gain_q16;
    I exc_q14[320];
    int loss_cnt;
    // silk_PLC_struct
    int plc_fs_khz;
    I plc_pitch_q8, plc_ltp[5], plc_lpc[16], plc_ltp_scale, plc_gain[2];
    int plc_subfr_length, plc_nb_subfr;
    I plc_rand_seed, plc_rand_scale, plc_conc_energy;
    int plc_conc_shift, plc_last_lost;
    // silk_CNG_struct
    int cng_fs_khz;
    I cng_nlsf[16], cng_gain, cng_seed, cng_exc[320], cng_synth[16];
    int signal_type, quant_offset;
    I gains_idx[4], nlsf_idx[17];
    int interp_q2;
    I lag_index;
    int contour, per_index, ltp_index[4], ltp_scale_index, seed;

    void reset() {
        std::memset(this, 0, sizeof(*this));
        first_frame_after_reset = 1;
        lag_prev = 100;
        last_gain_index = 10;
        prev_gain_q16 = 65536;
        interp_q2 = 4;
        plc_gain[0] = plc_gain[1] = 65536;
        plc_subfr_length = 20;
        plc_nb_subfr = 2;
    }
    void set_fs(const OpusTabs& T, int khz, int api) {
        subfr_length = 5 * khz;
        int frame_len = nb_subfr * subfr_length;
        if (fs_khz != khz || fs_api != api) {
            resampler.init(T, khz * 1000, api);
            fs_api = api;
        }
        if (fs_khz != khz || frame_len != frame_length) {
            if (khz == 8)
                contour_table = nb_subfr == 4 ? S_PITCH_CONTOUR_NB_ICDF : S_PITCH_CONTOUR_10MS_NB_ICDF;
            else
                contour_table = nb_subfr == 4 ? S_PITCH_CONTOUR_ICDF : S_PITCH_CONTOUR_10MS_ICDF;
            if (fs_khz != khz) {
                ltp_mem_length = 20 * khz;
                lpc_order = (khz == 8 || khz == 12) ? 10 : 16;
                wb = khz == 16;
                lag_low = khz == 16 ? S_UNIFORM8_ICDF : khz == 12 ? S_UNIFORM6_ICDF : S_UNIFORM4_ICDF;
                first_frame_after_reset = 1;
                lag_prev = 100;
                last_gain_index = 10;
                prev_signal_type = 0;
                for (auto& v : out_buf) v = 0;
                for (auto& v : s_lpc) v = 0;
            }
            fs_khz = khz;
            frame_length = frame_len;
        }
    }
};

struct SilkDec {
    int channels_api;
    SilkChannel ch[2];
    int n_internal, n_api;
    I pred_prev[2], s_mid[2], s_side[2];
    int prev_decode_only_middle;

    void reset() {
        ch[0].reset();
        ch[1].reset();
        pred_prev[0] = pred_prev[1] = 0;
        s_mid[0] = s_mid[1] = s_side[0] = s_side[1] = 0;
        prev_decode_only_middle = 0;
    }
};

static void decode_indices(const OpusTabs& T, SilkChannel& st, OpusRange& rd,
                           int frame, bool lbrr, int cond) {
    int ix;
    if (lbrr || st.vad_flags[frame]) ix = rd.icdf(T[S_TYPE_OFFSET_VAD_ICDF], 8) + 2;
    else ix = rd.icdf(T[S_TYPE_OFFSET_NO_VAD_ICDF], 8);
    st.signal_type = ix >> 1;
    st.quant_offset = ix & 1;
    if (cond == 2) st.gains_idx[0] = rd.icdf(T[S_DELTA_GAIN_ICDF], 8);
    else {
        st.gains_idx[0] = (I)rd.icdf(T[S_GAIN_ICDF] + 8 * st.signal_type, 8) << 3;
        st.gains_idx[0] += rd.icdf(T[S_UNIFORM8_ICDF], 8);
    }
    for (int i = 1; i < st.nb_subfr; ++i) st.gains_idx[i] = rd.icdf(T[S_DELTA_GAIN_ICDF], 8);
    NlsfCb cb = nlsf_cb(T, st.wb);
    st.nlsf_idx[0] = rd.icdf(cb.cb1_icdf + (st.signal_type >> 1) * 32, 8);
    I ec_ix[16], pred[16];
    nlsf_unpack(cb, (int)st.nlsf_idx[0], ec_ix, pred);
    for (int i = 0; i < cb.order; ++i) {
        int v = rd.icdf(cb.cb2_icdf + ec_ix[i], 8);
        if (v == 0) v -= rd.icdf(T[S_NLSF_EXT_ICDF], 8);
        else if (v == 8) v += rd.icdf(T[S_NLSF_EXT_ICDF], 8);
        st.nlsf_idx[i + 1] = v - 4;
    }
    st.interp_q2 = st.nb_subfr == 4 ? rd.icdf(T[S_NLSF_INTERP_ICDF], 8) : 4;
    if (st.signal_type == 2) {
        bool absolute = true;
        if (cond == 2 && st.ec_prev_signal_type == 2) {
            int delta = rd.icdf(T[S_PITCH_DELTA_ICDF], 8);
            if (delta > 0) {
                st.lag_index = i16(st.ec_prev_lag_index + delta - 9);
                absolute = false;
            }
        }
        if (absolute) {
            st.lag_index = (I)rd.icdf(T[S_PITCH_LAG_ICDF], 8) * (st.fs_khz >> 1);
            st.lag_index += rd.icdf(T[st.lag_low], 8);
        }
        st.ec_prev_lag_index = st.lag_index;
        st.contour = rd.icdf(T[st.contour_table], 8);
        st.per_index = rd.icdf(T[S_LTP_PER_INDEX_ICDF], 8);
        for (int k = 0; k < st.nb_subfr; ++k)
            st.ltp_index[k] = rd.icdf(T[S_LTP_GAIN_ICDF_0 + st.per_index], 8);
        st.ltp_scale_index = cond == 0 ? rd.icdf(T[S_LTPSCALE_ICDF], 8) : 0;
    }
    st.ec_prev_signal_type = st.signal_type;
    st.seed = rd.icdf(T[S_UNIFORM4_ICDF], 8);
}

static void shell_split(const OpusTabs& T, OpusRange& rd, int p, int table,
                        I* a, I* b) {
    if (p > 0) {
        *a = rd.icdf(T[table] + T[S_SHELL_CODE_TABLE_OFFSETS][p], 8);
        *b = p - *a;
    } else *a = *b = 0;
}

static void shell_decode(const OpusTabs& T, OpusRange& rd, I* out, int pulses4) {
    const int t0 = S_SHELL_CODE_TABLE0, t1 = S_SHELL_CODE_TABLE1,
              t2 = S_SHELL_CODE_TABLE2, t3 = S_SHELL_CODE_TABLE3;
    I p3[2], p2[4], p1[8];
    shell_split(T, rd, pulses4, t3, &p3[0], &p3[1]);
    shell_split(T, rd, (int)p3[0], t2, &p2[0], &p2[1]);
    shell_split(T, rd, (int)p2[0], t1, &p1[0], &p1[1]);
    shell_split(T, rd, (int)p1[0], t0, &out[0], &out[1]);
    shell_split(T, rd, (int)p1[1], t0, &out[2], &out[3]);
    shell_split(T, rd, (int)p2[1], t1, &p1[2], &p1[3]);
    shell_split(T, rd, (int)p1[2], t0, &out[4], &out[5]);
    shell_split(T, rd, (int)p1[3], t0, &out[6], &out[7]);
    shell_split(T, rd, (int)p3[1], t2, &p2[2], &p2[3]);
    shell_split(T, rd, (int)p2[2], t1, &p1[4], &p1[5]);
    shell_split(T, rd, (int)p1[4], t0, &out[8], &out[9]);
    shell_split(T, rd, (int)p1[5], t0, &out[10], &out[11]);
    shell_split(T, rd, (int)p2[3], t1, &p1[6], &p1[7]);
    shell_split(T, rd, (int)p1[6], t0, &out[12], &out[13]);
    shell_split(T, rd, (int)p1[7], t0, &out[14], &out[15]);
}

static std::vector<I> decode_pulses(const OpusTabs& T, OpusRange& rd,
                                    int signal_type, int quant_offset,
                                    int frame_length) {
    int rate = rd.icdf(T[S_RATE_LEVELS_ICDF] + 9 * (signal_type >> 1), 8);
    int n_blocks = frame_length >> 4;
    if (n_blocks * 16 < frame_length) n_blocks++;
    std::vector<I> pulses((size_t)n_blocks * 16, 0);
    std::vector<int> sums((size_t)n_blocks, 0), shifts((size_t)n_blocks, 0);
    const int32_t* ppb = T[S_PULSES_PER_BLOCK_ICDF];
    for (int i = 0; i < n_blocks; ++i) {
        sums[(size_t)i] = rd.icdf(ppb + 18 * rate, 8);
        while (sums[(size_t)i] == 17) {
            shifts[(size_t)i]++;
            sums[(size_t)i] = rd.icdf(ppb + 18 * 9 + (shifts[(size_t)i] == 10), 8);
            if (shifts[(size_t)i] > 30) { rd.error = 2; return pulses; }
        }
    }
    for (int i = 0; i < n_blocks; ++i)
        if (sums[(size_t)i] > 0) shell_decode(T, rd, pulses.data() + i * 16, sums[(size_t)i]);
    for (int i = 0; i < n_blocks; ++i)
        if (shifts[(size_t)i] > 0) {
            for (int k = 0; k < 16; ++k) {
                I q = pulses[(size_t)(i * 16 + k)];
                for (int j = 0; j < shifts[(size_t)i]; ++j)
                    q = (q << 1) + rd.icdf(T[S_LSB_ICDF], 8);
                pulses[(size_t)(i * 16 + k)] = q;
            }
            sums[(size_t)i] |= shifts[(size_t)i] << 5;
        }
    int base = 7 * (quant_offset + (signal_type << 1));
    int n_sign = (frame_length + 8) >> 4;
    for (int i = 0; i < n_sign; ++i) {
        int p = sums[(size_t)i];
        if (p > 0) {
            int icdf[2] = {T[S_SIGN_ICDF][base + ((p & 0x1F) < 6 ? (p & 0x1F) : 6)], 0};
            for (int j = 0; j < 16; ++j) {
                I& q = pulses[(size_t)(i * 16 + j)];
                if (q > 0) q *= (rd.icdf(icdf, 8) << 1) - 1;
            }
        }
    }
    return pulses;
}

static void bwexpander16(I* ar, int d, I chirp);

struct SilkCtrl {
    I gains[4], pred[2][16], pitch[4], ltp[20], ltp_scale;
};

static void decode_parameters(const OpusTabs& T, SilkChannel& st, int cond,
                              SilkCtrl& c) {
    I prev = st.last_gain_index;
    for (int k = 0; k < st.nb_subfr; ++k) {
        I ind = st.gains_idx[k];
        if (k == 0 && cond != 2) prev = imax(ind, prev - 16);
        else {
            I tmp = ind - 4, thresh = 2 * 36 - 64 + prev;
            if (tmp > thresh) prev += (tmp << 1) - thresh;
            else prev += tmp;
        }
        prev = prev < 0 ? 0 : prev > 63 ? 63 : prev;
        c.gains[k] = log2lin(imin(smulwb(1907825, prev) + 2090, 3967));
    }
    st.last_gain_index = prev;
    NlsfCb cb = nlsf_cb(T, st.wb);
    I nlsf[16];
    nlsf_decode(cb, st.nlsf_idx, nlsf);
    nlsf2a(T, nlsf, st.lpc_order, c.pred[1]);
    if (st.first_frame_after_reset == 1) st.interp_q2 = 4;
    if (st.interp_q2 < 4) {
        I nlsf0[16] = {0};
        for (int i = 0; i < st.lpc_order; ++i)
            nlsf0[i] = st.prev_nlsf[i] + ((st.interp_q2 * (nlsf[i] - st.prev_nlsf[i])) >> 2);
        nlsf2a(T, nlsf0, st.lpc_order, c.pred[0]);
    } else {
        for (int i = 0; i < st.lpc_order; ++i) c.pred[0][i] = c.pred[1][i];
    }
    for (int i = 0; i < st.lpc_order; ++i) st.prev_nlsf[i] = nlsf[i];
    if (st.loss_cnt) {
        bwexpander16(c.pred[0], st.lpc_order, 63570);
        bwexpander16(c.pred[1], st.lpc_order, 63570);
    }
    if (st.signal_type == 2) {
        int khz = st.fs_khz, size;
        const int32_t* cbk;
        if (khz == 8) {
            if (st.nb_subfr == 4) { cbk = T[S_CB_LAGS_STAGE2]; size = 11; }
            else { cbk = T[S_CB_LAGS_STAGE2_10MS]; size = 3; }
        } else {
            if (st.nb_subfr == 4) { cbk = T[S_CB_LAGS_STAGE3]; size = 34; }
            else { cbk = T[S_CB_LAGS_STAGE3_10MS]; size = 12; }
        }
        I min_lag = 2 * khz, max_lag = 18 * khz, lag = min_lag + st.lag_index;
        for (int k = 0; k < st.nb_subfr; ++k) {
            I v = lag + cbk[k * size + st.contour];
            c.pitch[k] = imax(min_lag, imin(max_lag, v));
        }
        const int32_t* vq = T[S_LTP_VQ_0 + st.per_index];
        for (int k = 0; k < st.nb_subfr; ++k)
            for (int i = 0; i < 5; ++i)
                c.ltp[k * 5 + i] = (I)vq[st.ltp_index[k] * 5 + i] << 7;
        c.ltp_scale = T[S_LTP_SCALES_Q14][st.ltp_scale_index];
    } else {
        for (int k = 0; k < 4; ++k) c.pitch[k] = 0;
        for (int k = 0; k < 20; ++k) c.ltp[k] = 0;
        st.per_index = 0;
        c.ltp_scale = 0;
    }
}

static void lpc_analysis_filter(const I* in, const I* b, int length, int d,
                                I* out) {
    for (int ix = 0; ix < d && ix < length; ++ix) out[ix] = 0;
    for (int ix = d; ix < length; ++ix) {
        const I* p = in + ix - 1;
        I acc = 0;
        for (int j = 0; j < d; ++j) acc = w32(acc + i16(p[-j]) * i16(b[j]));
        acc = w32((i16(p[1]) << 12) - acc);
        out[ix] = sat16(rshift_round(acc, 12));
    }
}

static void decode_core(const OpusTabs& T, SilkChannel& st, SilkCtrl& c,
                        const std::vector<I>& pulses, I* xq) {
    int L = st.frame_length, sub = st.subfr_length, ltp_mem = st.ltp_mem_length,
        order = st.lpc_order;
    I offset_q10 = T[S_QUANT_OFFSETS_Q10][2 * (st.signal_type >> 1) + st.quant_offset];
    bool interp = st.interp_q2 < 4;
    I seed = st.seed;
    I* exc = st.exc_q14;
    for (int i = 0; i < L; ++i) {
        seed = silk_rand(seed);
        I e = pulses[(size_t)i] << 14;
        if (e > 0) e -= 80 << 4;
        else if (e < 0) e += 80 << 4;
        e += offset_q10 << 4;
        if (seed < 0) e = -e;
        exc[i] = e;
        seed = w32(seed + pulses[(size_t)i]);
    }
    std::vector<I> s_lpc((size_t)(16 + sub), 0);
    for (int i = 0; i < 16; ++i) s_lpc[(size_t)i] = st.s_lpc[i];
    std::vector<I> s_ltp_q15((size_t)(ltp_mem + L), 0), s_ltp((size_t)ltp_mem, 0),
        res((size_t)sub);
    int buf_idx = ltp_mem;
    I lag = 0;
    for (int k = 0; k < st.nb_subfr; ++k) {
        const I* a_q12 = c.pred[k >> 1];
        I* b_q14 = c.ltp + k * 5;
        int signal_type = st.signal_type;
        I gain = c.gains[k], gain_q10 = gain >> 6;
        I inv_gain = inverse32_varq(gain, 47), gain_adj;
        if (gain != st.prev_gain_q16) {
            gain_adj = div32_varq(st.prev_gain_q16, gain, 16);
            for (int i = 0; i < 16; ++i) s_lpc[(size_t)i] = smulww(gain_adj, s_lpc[(size_t)i]);
        } else gain_adj = (I)1 << 16;
        st.prev_gain_q16 = gain;
        if (st.loss_cnt && st.prev_signal_type == 2 && st.signal_type != 2 && k < 2) {
            for (int i = 0; i < 5; ++i) b_q14[i] = 0;
            b_q14[2] = 4096;
            signal_type = 2;
            c.pitch[k] = st.lag_prev;
        }
        if (signal_type == 2) {
            lag = c.pitch[k];
            if (k == 0 || (k == 2 && interp)) {
                int start = ltp_mem - (int)lag - order - 2;
                if (start < 0) return;
                if (k == 2)
                    for (int i = 0; i < 2 * sub; ++i) st.out_buf[ltp_mem + i] = xq[i];
                lpc_analysis_filter(st.out_buf + start + k * sub, a_q12,
                                    ltp_mem - start, order, s_ltp.data() + start);
                if (k == 0) inv_gain = w32(smulwb(inv_gain, c.ltp_scale) << 2);
                for (int i = 0; i < lag + 2; ++i)
                    s_ltp_q15[(size_t)(buf_idx - i - 1)] = smulwb(inv_gain, s_ltp[(size_t)(ltp_mem - i - 1)]);
            } else if (gain_adj != (I)1 << 16) {
                for (int i = 0; i < lag + 2; ++i)
                    s_ltp_q15[(size_t)(buf_idx - i - 1)] = smulww(gain_adj, s_ltp_q15[(size_t)(buf_idx - i - 1)]);
            }
        }
        int base = k * sub;
        const I* r;
        if (signal_type == 2) {
            I p = buf_idx - lag + 2;
            if (p < 4) return;
            for (int i = 0; i < sub; ++i) {
                I pred = 2;
                pred = smlawb(pred, s_ltp_q15[(size_t)p], b_q14[0]);
                pred = smlawb(pred, s_ltp_q15[(size_t)(p - 1)], b_q14[1]);
                pred = smlawb(pred, s_ltp_q15[(size_t)(p - 2)], b_q14[2]);
                pred = smlawb(pred, s_ltp_q15[(size_t)(p - 3)], b_q14[3]);
                pred = smlawb(pred, s_ltp_q15[(size_t)(p - 4)], b_q14[4]);
                p++;
                res[(size_t)i] = exc[base + i] + (pred << 1);
                s_ltp_q15[(size_t)buf_idx] = res[(size_t)i] << 1;
                buf_idx++;
            }
            r = res.data();
        } else r = exc + base;
        for (int i = 0; i < sub; ++i) {
            I pred = order >> 1;
            int at = 16 + i;
            for (int j = 0; j < order; ++j) pred = smlawb(pred, s_lpc[(size_t)(at - 1 - j)], a_q12[j]);
            s_lpc[(size_t)at] = sat32(r[i] + lshift_sat32(pred, 4));
            xq[base + i] = sat16(rshift_round(smulww(s_lpc[(size_t)at], gain_q10), 8));
        }
        for (int i = 0; i < 16; ++i) s_lpc[(size_t)i] = s_lpc[(size_t)(sub + i)];
        for (int i = 16; i < 16 + sub; ++i) s_lpc[(size_t)i] = 0;
    }
    for (int i = 0; i < 16; ++i) st.s_lpc[i] = s_lpc[(size_t)i];
}

static void plc_reset(SilkChannel& st) {
    st.plc_pitch_q8 = (I)st.frame_length << 7;
    st.plc_gain[0] = st.plc_gain[1] = 65536;
    st.plc_subfr_length = 20;
    st.plc_nb_subfr = 2;
}

// silk_PLC_update: what a good frame leaves for a concealment
static void plc_update(SilkChannel& st, const SilkCtrl& c) {
    I gain = 0;
    if (st.signal_type == 2) {
        for (int j = 0; j * st.subfr_length < c.pitch[st.nb_subfr - 1]; ++j) {
            if (j == st.nb_subfr) break;
            int k = st.nb_subfr - 1 - j;
            I tmp = 0;
            for (int i = 0; i < 5; ++i) tmp += c.ltp[k * 5 + i];
            if (tmp > gain) {
                gain = tmp;
                st.plc_pitch_q8 = c.pitch[k] << 8;
            }
        }
        for (int i = 0; i < 5; ++i) st.plc_ltp[i] = 0;
        st.plc_ltp[2] = gain;
        if (gain < 11469) {
            I scale = ((I)11469 << 10) / imax(gain, 1);
            for (int i = 0; i < 5; ++i) st.plc_ltp[i] = smulbb(st.plc_ltp[i], scale) >> 10;
        } else if (gain > 15565) {
            I scale = ((I)15565 << 14) / imax(gain, 1);
            for (int i = 0; i < 5; ++i) st.plc_ltp[i] = smulbb(st.plc_ltp[i], scale) >> 14;
        }
    } else {
        st.plc_pitch_q8 = smulbb(st.fs_khz, 18) << 8;
        for (int i = 0; i < 5; ++i) st.plc_ltp[i] = 0;
    }
    for (int i = 0; i < 16; ++i) st.plc_lpc[i] = i < st.lpc_order ? c.pred[1][i] : 0;
    st.plc_ltp_scale = c.ltp_scale;
    st.plc_gain[0] = c.gains[st.nb_subfr - 2];
    st.plc_gain[1] = c.gains[st.nb_subfr - 1];
    st.plc_subfr_length = st.subfr_length;
    st.plc_nb_subfr = st.nb_subfr;
}

static void bwexpander16(I* ar, int d, I chirp) {
    I minus1 = chirp - 65536;
    for (int i = 0; i < d - 1; ++i) {
        ar[i] = i16(rshift_round(chirp * ar[i], 16));
        chirp += rshift_round(chirp * minus1, 16);
    }
    ar[d - 1] = i16(rshift_round(chirp * ar[d - 1], 16));
}

static void sum_sqr_shift(const I* x, int n, I* energy, int* shift) {
    int shft = 31 - clz32(n);
    I nrg = n;
    for (int i = 0; i < n - 1; i += 2)
        nrg += ((x[i] * x[i] + x[i + 1] * x[i + 1]) & 0xFFFFFFFFLL) >> shft;
    if (n & 1) nrg += (x[n - 1] * x[n - 1]) >> shft;
    shft = shft + 3 - clz32(nrg);
    if (shft < 0) shft = 0;
    nrg = 0;
    for (int i = 0; i < n - 1; i += 2)
        nrg += ((x[i] * x[i] + x[i + 1] * x[i + 1]) & 0xFFFFFFFFLL) >> shft;
    if (n & 1) nrg += (x[n - 1] * x[n - 1]) >> shft;
    *energy = w32(nrg);
    *shift = shft;
}

// silk_PLC_conceal: a lost frame from the last good one's filters and its
// excitation
static void plc_conceal(SilkChannel& st, SilkCtrl& c, I* out) {
    static const I HARM[2] = {32440, 31130}, RAND_V[2] = {31130, 26214},
                   RAND_UV[2] = {32440, 29491};
    const int L = st.frame_length, sub = st.subfr_length,
              ltp_mem = st.ltp_mem_length, order = st.lpc_order;
    I prev_gain_q10[2] = {st.plc_gain[0] >> 6, st.plc_gain[1] >> 6};
    if (st.first_frame_after_reset)
        for (auto& v : st.plc_lpc) v = 0;
    std::vector<I> bufs((size_t)(2 * sub));
    for (int k = 0; k < 2; ++k) {
        int base = (k + st.nb_subfr - 2) * sub;
        for (int i = 0; i < sub; ++i)
            bufs[(size_t)(k * sub + i)] = sat16(smulww(st.exc_q14[base + i], prev_gain_q10[k]) >> 8);
    }
    I e1, e2;
    int s1, s2;
    sum_sqr_shift(bufs.data(), sub, &e1, &s1);
    sum_sqr_shift(bufs.data() + sub, sub, &e2, &s2);
    int rand_at;
    if ((e1 >> s2) < (e2 >> s1))
        rand_at = std::max(0, (st.plc_nb_subfr - 1) * st.plc_subfr_length - 128);
    else
        rand_at = std::max(0, st.plc_nb_subfr * st.plc_subfr_length - 128);
    I* b_q14 = st.plc_ltp;
    I rand_scale = st.plc_rand_scale;
    const int att = st.loss_cnt < 1 ? st.loss_cnt : 1;
    I harm_gain = HARM[att];
    I rand_gain = st.prev_signal_type == 2 ? RAND_V[att] : RAND_UV[att];
    bwexpander16(st.plc_lpc, order, 64881);
    I a_q12[16];
    for (int i = 0; i < order; ++i) a_q12[i] = st.plc_lpc[i];
    if (st.loss_cnt == 0) {
        rand_scale = 1 << 14;
        if (st.prev_signal_type == 2) {
            for (int i = 0; i < 5; ++i) rand_scale -= b_q14[i];
            rand_scale = imax(3277, rand_scale);
            rand_scale = i16(smulbb(rand_scale, st.plc_ltp_scale) >> 14);
        } else {
            I inv = lpc_inverse_pred_gain(st.plc_lpc, order);
            I down = imin(((I)1 << 30) >> 3, inv);
            down = imax(((I)1 << 30) >> 8, down);
            down = w32(down << 3);
            rand_gain = smulwb(down, rand_gain) >> 14;
        }
    }
    I seed = st.plc_rand_seed;
    I lag = rshift_round(st.plc_pitch_q8, 8);
    int buf_idx = ltp_mem;
    int idx = ltp_mem - (int)lag - order - 2;
    if (idx <= 0) idx = 1;
    std::vector<I> s_ltp((size_t)ltp_mem, 0), s_ltp_q14((size_t)(ltp_mem + L), 0);
    lpc_analysis_filter(st.out_buf + idx, a_q12, ltp_mem - idx, order, s_ltp.data() + idx);
    I inv_gain = imin(inverse32_varq(st.plc_gain[1], 46), 0x7FFFFFFF >> 1);
    for (int i = idx + order; i < ltp_mem; ++i)
        s_ltp_q14[(size_t)i] = smulwb(inv_gain, s_ltp[(size_t)i]);
    const I* rnd = st.exc_q14 + rand_at;
    for (int k = 0; k < st.nb_subfr; ++k) {
        I p = buf_idx - lag + 2;
        if (p < 4) p = 4;
        for (int i = 0; i < sub; ++i) {
            I pred = 2;
            pred = smlawb(pred, s_ltp_q14[(size_t)p], b_q14[0]);
            pred = smlawb(pred, s_ltp_q14[(size_t)(p - 1)], b_q14[1]);
            pred = smlawb(pred, s_ltp_q14[(size_t)(p - 2)], b_q14[2]);
            pred = smlawb(pred, s_ltp_q14[(size_t)(p - 3)], b_q14[3]);
            pred = smlawb(pred, s_ltp_q14[(size_t)(p - 4)], b_q14[4]);
            p++;
            seed = silk_rand(seed);
            int j = (int)((seed >> 25) & 127);
            s_ltp_q14[(size_t)buf_idx] = w32(smlawb(pred, rnd[j], rand_scale) << 2);
            buf_idx++;
        }
        for (int j = 0; j < 5; ++j) b_q14[j] = smulbb(harm_gain, b_q14[j]) >> 15;
        if (st.signal_type != 0) rand_scale = smulbb(rand_scale, rand_gain) >> 15;
        st.plc_pitch_q8 = smlawb(st.plc_pitch_q8, st.plc_pitch_q8, 655);
        st.plc_pitch_q8 = imin(st.plc_pitch_q8, smulbb(18, st.fs_khz) << 8);
        lag = rshift_round(st.plc_pitch_q8, 8);
    }
    const int base = ltp_mem - 16;
    for (int i = 0; i < 16; ++i) s_ltp_q14[(size_t)(base + i)] = st.s_lpc[i];
    for (int i = 0; i < L; ++i) {
        I pred = order >> 1;
        const int at = base + 16 + i;
        for (int j = 0; j < order; ++j) pred = smlawb(pred, s_ltp_q14[(size_t)(at - 1 - j)], a_q12[j]);
        s_ltp_q14[(size_t)at] = sat32(s_ltp_q14[(size_t)at] + lshift_sat32(pred, 4));
        out[i] = sat16(rshift_round(smulww(s_ltp_q14[(size_t)at], prev_gain_q10[1]), 8));
    }
    for (int i = 0; i < 16; ++i) st.s_lpc[i] = s_ltp_q14[(size_t)(base + L + i)];
    st.plc_rand_seed = seed;
    st.plc_rand_scale = rand_scale;
    for (int k = 0; k < 4; ++k) c.pitch[k] = lag;
}

static I sqrt_approx(I x);

// silk_PLC_glue_frames: a good frame after concealed ones fades in from the
// concealment's energy where it is louder
static void plc_glue_frames(SilkChannel& st, I* frame, int L) {
    if (st.loss_cnt) {
        sum_sqr_shift(frame, L, &st.plc_conc_energy, &st.plc_conc_shift);
        st.plc_last_lost = 1;
        return;
    }
    if (st.plc_last_lost) {
        I energy;
        int shift;
        sum_sqr_shift(frame, L, &energy, &shift);
        I conc = st.plc_conc_energy;
        if (shift > st.plc_conc_shift) conc >>= shift - st.plc_conc_shift;
        else if (shift < st.plc_conc_shift) energy >>= st.plc_conc_shift - shift;
        if (energy > conc) {
            int lz = clz32(conc) - 1;
            conc = w32(conc << lz);
            energy >>= std::max(24 - lz, 0);
            I frac = stdiv(conc, imax(energy, 1));
            I gain = sqrt_approx(frac) << 4;
            I slope = stdiv(((I)1 << 16) - gain, L) << 2;
            for (int i = 0; i < L; ++i) {
                frame[i] = smulwb(gain, frame[i]);
                gain += slope;
                if (gain > (I)1 << 16) break;
            }
        }
        st.plc_conc_energy = conc;
    }
    st.plc_last_lost = 0;
}

static I sqrt_approx(I x) {
    if (x <= 0) return 0;
    int lz = clz32(x);
    uint32_t u = (uint32_t)(uint64_t)x;
    int rot = (24 - lz) & 31;
    uint32_t r = rot ? ((u >> rot) | (u << (32 - rot))) : u;
    I frac = r & 0x7F;
    I y = (lz & 1) ? 32768 : 46214;
    y >>= lz >> 1;
    return smlawb(y, y, smulbb(213, frac));
}

// silk_CNG: the comfort noise's parameters from frames of no voice
// activity, and the noise added to a concealed frame
static void silk_cng(const OpusTabs& T, SilkChannel& st, const SilkCtrl& c,
                     I* frame, int L) {
    const int order = st.lpc_order;
    if (st.fs_khz != st.cng_fs_khz) {
        I step = 0x7FFF / (order + 1);
        for (int i = 0; i < 16; ++i) st.cng_nlsf[i] = i < order ? step * (i + 1) : 0;
        st.cng_gain = 0;
        st.cng_seed = 3176576;
        st.cng_fs_khz = st.fs_khz;
    }
    if (st.loss_cnt == 0 && st.prev_signal_type == 0) {
        for (int i = 0; i < order; ++i)
            st.cng_nlsf[i] += smulwb(st.prev_nlsf[i] - st.cng_nlsf[i], 16348);
        I max_gain = 0;
        int subfr = 0;
        for (int i = 0; i < st.nb_subfr; ++i)
            if (c.gains[i] > max_gain) { max_gain = c.gains[i]; subfr = i; }
        const int sub = st.subfr_length, n = (st.nb_subfr - 1) * sub;
        for (int i = n - 1; i >= 0; --i) st.cng_exc[sub + i] = st.cng_exc[i];
        for (int i = 0; i < sub; ++i) st.cng_exc[i] = st.exc_q14[subfr * sub + i];
        for (int i = 0; i < st.nb_subfr; ++i)
            st.cng_gain += smulwb(c.gains[i] - st.cng_gain, 4634);
    }
    if (!st.loss_cnt) {
        for (int i = 0; i < order; ++i) st.cng_synth[i] = 0;
        return;
    }
    I g = smulww(st.plc_rand_scale, st.plc_gain[1]);
    if (g >= (1 << 21) || st.cng_gain > (1 << 23)) {
        g = (g >> 16) * (g >> 16);
        g = w32((st.cng_gain >> 16) * (st.cng_gain >> 16) - (g << 5));
        g = w32(sqrt_approx(g) << 16);
    } else {
        g = smulww(g, g);
        g = w32(smulww(st.cng_gain, st.cng_gain) - (g << 5));
        g = w32(sqrt_approx(g) << 8);
    }
    const I gain_q10 = g >> 6;
    int mask = 255;
    while (mask > L) mask >>= 1;
    std::vector<I> sig((size_t)(16 + L));
    for (int i = 0; i < 16; ++i) sig[(size_t)i] = st.cng_synth[i];
    I seed = st.cng_seed;
    for (int i = 0; i < L; ++i) {
        seed = silk_rand(seed);
        sig[(size_t)(16 + i)] = st.cng_exc[(seed >> 24) & mask];
    }
    st.cng_seed = seed;
    I a_q12[16];
    nlsf2a(T, st.cng_nlsf, order, a_q12);
    for (int i = 0; i < L; ++i) {
        const int at = 16 + i;
        I pred = order >> 1;
        for (int j = 0; j < order; ++j) pred = smlawb(pred, sig[(size_t)(at - 1 - j)], a_q12[j]);
        sig[(size_t)at] = sat32(sig[(size_t)at] + lshift_sat32(pred, 4));
        frame[i] = sat16(frame[i] + sat16(rshift_round(smulww(sig[(size_t)at], gain_q10), 8)));
    }
    for (int i = 0; i < 16; ++i) st.cng_synth[i] = sig[(size_t)(L + i)];
}

static void silk_decode_frame(const OpusTabs& T, SilkChannel& st, OpusRange* rd,
                              int cond, I* out) {
    if (st.fs_khz != st.plc_fs_khz) {
        plc_reset(st);
        st.plc_fs_khz = st.fs_khz;
    }
    SilkCtrl c;
    if (rd) {
        decode_indices(T, st, *rd, st.frames_decoded, false, cond);
        std::vector<I> pulses = decode_pulses(T, *rd, st.signal_type, st.quant_offset,
                                              st.frame_length);
        decode_parameters(T, st, cond, c);
        decode_core(T, st, c, pulses, out);
        plc_update(st, c);
        st.loss_cnt = 0;
        st.prev_signal_type = st.signal_type;
        st.first_frame_after_reset = 0;
    } else {
        st.signal_type = st.prev_signal_type;
        plc_conceal(st, c, out);
        st.loss_cnt++;
    }
    int L = st.frame_length, mv = st.ltp_mem_length - L;
    for (int i = 0; i < mv; ++i) st.out_buf[i] = st.out_buf[L + i];
    for (int i = 0; i < L; ++i) st.out_buf[mv + i] = out[i];
    silk_cng(T, st, c, out, L);
    plc_glue_frames(st, out, L);
    st.lag_prev = c.pitch[st.nb_subfr - 1];
}

static void stereo_decode_pred(const OpusTabs& T, OpusRange& rd, I* pred) {
    int n = rd.icdf(T[S_STEREO_PRED_JOINT_ICDF], 8);
    int ix[2][3] = {{0, 0, n / 5}, {0, 0, n - 5 * (n / 5)}};
    for (int k = 0; k < 2; ++k) {
        ix[k][0] = rd.icdf(T[S_UNIFORM3_ICDF], 8);
        ix[k][1] = rd.icdf(T[S_UNIFORM5_ICDF], 8);
    }
    const int32_t* q = T[S_STEREO_PRED_QUANT_Q13];
    for (int k = 0; k < 2; ++k) {
        ix[k][0] += 3 * ix[k][2];
        I low = q[ix[k][0]];
        I step = smulwb(q[ix[k][0] + 1] - low, 6554);
        pred[k] = low + i16(step) * i16(2 * ix[k][1] + 1);
    }
    pred[0] -= pred[1];
}

static void stereo_ms_to_lr(SilkDec& d, I* x1, I* x2, const I* pred, int khz,
                            int n) {
    x1[0] = d.s_mid[0]; x1[1] = d.s_mid[1];
    x2[0] = d.s_side[0]; x2[1] = d.s_side[1];
    d.s_mid[0] = x1[n]; d.s_mid[1] = x1[n + 1];
    d.s_side[0] = x2[n]; d.s_side[1] = x2[n + 1];
    I p0 = d.pred_prev[0], p1 = d.pred_prev[1];
    int interp = 8 * khz;
    I denom = (1 << 16) / interp;
    I d0 = rshift_round(smulbb(pred[0] - d.pred_prev[0], denom), 16);
    I d1 = rshift_round(smulbb(pred[1] - d.pred_prev[1], denom), 16);
    for (int k = 0; k < n; ++k) {
        if (k < interp) { p0 += d0; p1 += d1; }
        else { p0 = pred[0]; p1 = pred[1]; }
        I s = ((x1[k] + x1[k + 2]) + (x1[k + 1] << 1)) << 9;
        s = smlawb(x2[k + 1] << 8, s, p0);
        s = smlawb(s, x1[k + 1] << 11, p1);
        x2[k + 1] = sat16(rshift_round(s, 8));
    }
    d.pred_prev[0] = pred[0];
    d.pred_prev[1] = pred[1];
    for (int k = 0; k < n; ++k) {
        I a = x1[k + 1], b = x2[k + 1];
        x1[k + 1] = sat16(a + b);
        x2[k + 1] = sat16(a - b);
    }
}

static int silk_decode_call(const OpusTabs& T, SilkDec& d, OpusRange* rdp,
                            int n_internal, int internal_rate, int payload_ms,
                            bool new_packet, std::vector<I>* result) {
    const bool lost = rdp == nullptr;
    OpusRange dummy{};
    OpusRange& rd = lost ? dummy : *rdp;
    SilkChannel* chs = d.ch;
    if (new_packet)
        for (int n = 0; n < n_internal; ++n) chs[n].frames_decoded = 0;
    if (n_internal > d.n_internal) chs[1].reset();
    bool stereo_to_mono = n_internal == 1 && d.n_internal == 2
        && internal_rate == 1000 * chs[0].fs_khz;
    if (chs[0].frames_decoded == 0) {
        int per, sub;
        switch (payload_ms) {
        case 10: per = 1; sub = 2; break;
        case 20: per = 1; sub = 4; break;
        case 40: per = 2; sub = 4; break;
        case 60: per = 3; sub = 4; break;
        default: return -1;
        }
        for (int n = 0; n < n_internal; ++n) {
            chs[n].frames_per_packet = per;
            chs[n].nb_subfr = sub;
            chs[n].set_fs(T, (internal_rate >> 10) + 1, 48000);
        }
    }
    if (d.channels_api == 2 && n_internal == 2 && (d.n_api == 1 || d.n_internal == 1)) {
        d.pred_prev[0] = d.pred_prev[1] = 0;
        d.s_side[0] = d.s_side[1] = 0;
        chs[1].resampler = chs[0].resampler;
    }
    d.n_api = d.channels_api;
    d.n_internal = n_internal;
    int decode_only_middle = 0;
    if (!lost && chs[0].frames_decoded == 0) {
        for (int n = 0; n < n_internal; ++n) {
            for (int i = 0; i < chs[n].frames_per_packet; ++i)
                chs[n].vad_flags[i] = rd.bit_logp(1);
            chs[n].lbrr_flag = rd.bit_logp(1);
        }
        for (int n = 0; n < n_internal; ++n) {
            chs[n].lbrr_flags[0] = chs[n].lbrr_flags[1] = chs[n].lbrr_flags[2] = 0;
            if (chs[n].lbrr_flag) {
                if (chs[n].frames_per_packet == 1) chs[n].lbrr_flags[0] = 1;
                else {
                    int sym = rd.icdf(T[chs[n].frames_per_packet == 2
                                        ? S_LBRR_FLAGS_2_ICDF : S_LBRR_FLAGS_3_ICDF], 8) + 1;
                    for (int i = 0; i < chs[n].frames_per_packet; ++i)
                        chs[n].lbrr_flags[i] = (sym >> i) & 1;
                }
            }
        }
        for (int i = 0; i < chs[0].frames_per_packet; ++i)
            for (int n = 0; n < n_internal; ++n)
                if (chs[n].lbrr_flags[i]) {
                    if (n_internal == 2 && n == 0) {
                        I tmp[2];
                        stereo_decode_pred(T, rd, tmp);
                        if (chs[1].lbrr_flags[i] == 0)
                            rd.icdf(T[S_STEREO_ONLY_MID_ICDF], 8);
                    }
                    int cond = (i > 0 && chs[n].lbrr_flags[i - 1]) ? 2 : 0;
                    decode_indices(T, chs[n], rd, i, true, cond);
                    decode_pulses(T, rd, chs[n].signal_type, chs[n].quant_offset,
                                  chs[n].frame_length);
                }
    }
    I ms_pred[2] = {0, 0};
    if (n_internal == 2) {
        if (lost) {
            ms_pred[0] = d.pred_prev[0];
            ms_pred[1] = d.pred_prev[1];
        } else {
            stereo_decode_pred(T, rd, ms_pred);
            if (chs[1].vad_flags[chs[0].frames_decoded] == 0)
                decode_only_middle = rd.icdf(T[S_STEREO_ONLY_MID_ICDF], 8);
        }
    }
    if (n_internal == 2 && decode_only_middle == 0 && d.prev_decode_only_middle == 1) {
        SilkChannel& c1 = chs[1];
        for (auto& v : c1.out_buf) v = 0;
        for (auto& v : c1.s_lpc) v = 0;
        c1.lag_prev = 100;
        c1.last_gain_index = 10;
        c1.prev_signal_type = 0;
        c1.first_frame_after_reset = 1;
    }
    int frame_len = chs[0].frame_length;
    if (frame_len <= 0 || frame_len > 320) return -1;
    std::vector<I> outs0((size_t)(frame_len + 2), 0), outs1((size_t)(frame_len + 2), 0);
    I* outs[2] = {outs0.data(), outs1.data()};
    bool has_side = !(lost ? d.prev_decode_only_middle : decode_only_middle);
    int n_dec = frame_len;
    for (int n = 0; n < n_internal; ++n) {
        if (n == 0 || has_side) {
            int fi = chs[0].frames_decoded - n, cond;
            if (fi <= 0) cond = 0;
            else if (n > 0 && d.prev_decode_only_middle) cond = 1;
            else cond = 2;
            if (chs[n].frame_length != frame_len) return -1;
            silk_decode_frame(T, chs[n], rdp, cond, outs[n] + 2);
        }
        chs[n].frames_decoded++;
    }
    if (d.channels_api == 2 && n_internal == 2)
        stereo_ms_to_lr(d, outs[0], outs[1], ms_pred, chs[0].fs_khz, n_dec);
    else {
        outs[0][0] = d.s_mid[0];
        outs[0][1] = d.s_mid[1];
        d.s_mid[0] = outs[0][n_dec];
        d.s_mid[1] = outs[0][n_dec + 1];
    }
    int nres = 0;
    for (int n = 0; n < (d.channels_api < n_internal ? d.channels_api : n_internal); ++n) {
        result[n].clear();
        silk_resample(T, chs[n].resampler, outs[n] + 1, n_dec, result[n]);
        nres++;
    }
    if (d.channels_api == 2 && n_internal == 1) {
        result[1].clear();
        if (stereo_to_mono) silk_resample(T, chs[1].resampler, outs[0] + 1, n_dec, result[1]);
        else result[1] = result[0];
    }
    if (lost)
        for (int n = 0; n < n_internal; ++n) chs[n].last_gain_index = 10;
    else
        d.prev_decode_only_middle = decode_only_middle;
    return (int)result[0].size();
}

extern "C" void* silk_new(int channels_api) {
    SilkDec* d = new SilkDec();
    d->channels_api = channels_api;
    d->n_internal = d->n_api = 0;
    d->reset();
    return d;
}

extern "C" void silk_reset(void* h) { static_cast<SilkDec*>(h)->reset(); }

extern "C" void silk_free(void* h) { delete static_cast<SilkDec*>(h); }

// An Opus frame's SILK part: silk.decode of audio/silk.py (with no buf,
// a lost frame's concealment). out int16 [frame_size][channels_api] at
// 48 kHz. Returns 0, or -1 on a corrupt frame.
extern "C" int64_t silk_frame(void* h, const uint8_t* buf, int64_t* range,
                   const int32_t* blob, const int64_t* off, int n_tables,
                   int n_internal, int internal_rate, int payload_ms,
                   int frame_size, int16_t* out) {
    if (n_tables != OPUS_TABLE_COUNT || n_internal < 1 || n_internal > 2)
        return -1;
    OpusTabs T{blob, off};
    SilkDec& d = *static_cast<SilkDec*>(h);
    OpusRange rd{};
    if (buf) rd.load(buf, range);
    std::vector<I> result[2];
    int done = 0, ch = d.channels_api;
    while (done < frame_size) {
        int got = silk_decode_call(T, d, buf ? &rd : nullptr, n_internal,
                                   internal_rate, payload_ms, done == 0,
                                   result);
        if (got <= 0 || rd.error == 2) {
            if (buf) rd.store(range);
            return -1;
        }
        for (int k = 0; k < got && done + k < frame_size; ++k)
            for (int c = 0; c < ch; ++c)
                out[(size_t)(done + k) * ch + c] = (int16_t)result[c][(size_t)k];
        done += got;
    }
    if (buf) rd.store(range);
    return 0;
}

// -- opusfile's 16-bit conversion (audio/ogg_opus.py) -----------------------------

static void soft_clip(float* x, int64_t n, int ch, float* mem) {
    if (n < 1) return;
    for (int64_t i = 0; i < n * ch; ++i) {
        float v = x[i];
        x[i] = v < -2.f ? -2.f : (v > 2.f ? 2.f : v);
    }
    for (int c = 0; c < ch; ++c) {
        float* col = x + c;
        float a = mem[c];
        for (int64_t i = 0; i < n; ++i) {
            if (col[i * ch] * a >= 0) break;
            col[i * ch] = col[i * ch] + a * col[i * ch] * col[i * ch];
        }
        int64_t curr = 0;
        float x0 = col[0];
        while (true) {
            int64_t i = curr;
            while (i < n && col[i * ch] >= -1 && col[i * ch] <= 1) ++i;
            if (i == n) { a = 0; break; }
            int64_t peak = i, start = i, end = i;
            float maxval = std::fabs(col[i * ch]);
            while (start > 0 && col[i * ch] * col[(start - 1) * ch] >= 0) start--;
            while (end < n && col[i * ch] * col[end * ch] >= 0) {
                if (std::fabs(col[end * ch]) > maxval) {
                    maxval = std::fabs(col[end * ch]);
                    peak = end;
                }
                end++;
            }
            bool special = start == 0 && col[i * ch] * col[0] >= 0;
            a = (maxval - 1.f) / (maxval * maxval);
            a = a + a * 2.4e-7f;
            if (col[i * ch] > 0) a = -a;
            for (int64_t j = start; j < end; ++j)
                col[j * ch] = col[j * ch] + a * col[j * ch] * col[j * ch];
            if (special && peak >= 2) {
                float offset = x0 - col[0];
                float delta = offset / (float)peak;
                for (int64_t j = curr; j < peak; ++j) {
                    offset = offset - delta;
                    col[j * ch] = col[j * ch] + offset;
                    float v = col[j * ch];
                    col[j * ch] = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
                }
            }
            curr = end;
            if (curr == n) break;
        }
        mem[c] = a;
    }
}

// One op_read piece: float32 [n][ch] (soft-clipped in place) -> int16.
// ms: the dither's mute count and seed.
extern "C" void opus_pcm16(float* x, int64_t n, int ch, float* clip, float* da,
                float* db, int64_t* ms, int16_t* out) {
    static const float B[4] = {2.2374f, -0.7339f, -0.1251f, -0.6033f};
    static const float A[4] = {0.9030f, 0.0116f, -0.5853f, -0.2571f};
    const float gain = 32753.0f, prng_gain = 1.0f / 4294967296.0f;
    soft_clip(x, n, ch, clip);
    int64_t mute = ms[0];
    uint32_t seed = (uint32_t)ms[1];
    if (mute > 64)
        for (int k = 0; k < 4 * ch; ++k) da[k] = 0.f;
    for (int64_t i = 0; i < n; ++i) {
        bool silent = true;
        for (int c = 0; c < ch; ++c) {
            float s = x[i * ch + c];
            silent = silent && s == 0;
            s = s * gain;
            float err = 0.f;
            for (int j = 0; j < 4; ++j)
                err = err + (B[j] * db[c * 4 + j] - A[j] * da[c * 4 + j]);
            for (int j = 3; j > 0; --j) da[c * 4 + j] = da[c * 4 + j - 1];
            for (int j = 3; j > 0; --j) db[c * 4 + j] = db[c * 4 + j - 1];
            da[c * 4] = err;
            s = s - err;
            float r;
            if (mute > 16) r = 0.f;
            else {
                seed = seed * 96314165u + 907633515u;
                r = (float)seed * prng_gain;
                seed = seed * 96314165u + 907633515u;
                r = r - (float)seed * prng_gain;
            }
            float v = s + r;
            v = v < -32768.f ? -32768.f : (v > 32767.f ? 32767.f : v);
            int si = (int)std::nearbyint(v);
            out[i * ch + c] = (int16_t)si;
            if (mute > 16) db[c * 4] = 0.f;
            else {
                float e = (float)si - s;
                db[c * 4] = e < -1.5f ? -1.5f : (e > 1.5f ? 1.5f : e);
            }
        }
        mute++;
        if (!silent) mute = 0;
    }
    ms[0] = mute < 65 ? mute : 65;
    ms[1] = seed;
}
