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
// scale factors and the Huffman decode of each granule's regions. Vorbis (audio/vorbis.py): the scalar codebook decode and
// one packet's residue decode. Each has a plain Python version in its
// module that decodes to the same bits; every read is bounds-checked, and
// every loop is bounded by the sizes the caller allocated.
//
// Host code with a plain C interface, built by ops/_build.py build_host
// into qwen3_asr_tpu_torch/_build/ at first use and loaded with ctypes
// (audio/native.py).

#include <cstdint>
#include <cstddef>
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

}  // extern "C"
