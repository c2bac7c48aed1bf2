// Baseline JPEG scan decode: Huffman decode, dequantisation and an integer
// inverse DCT, one 8x8 block at a time: libjpeg's "islow" (jidctint.c) or
// FFmpeg's "simple" IDCT (libavcodec/simple_idct_template.c, 8-bit), the one
// its MJPEG decoder runs.
//
// Native counterpart of hive_tpu_torch/image_codecs.py's `_decode_scan` (a
// Python loop over symbols) followed by `_idct_planes`; the Python side
// parses the markers, splits the entropy-coded data at its restart markers
// and removes the byte stuffing, then upsamples and converts colour. Pixels
// equal those of the Python path, and of libjpeg(-turbo)'s default decode
// (islow) or FFmpeg's (simple).

#include <cstdint>
#include <cstring>
#include <vector>

#include "simple_idct.h"

namespace {

// Natural (row-major) index of the k-th coefficient in zigzag order.
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A 16-bit lookahead table: for every 16-bit window, the symbol whose code
// starts it and that code's length (0 where no code matches).
struct Huffman {
    std::vector<uint8_t> symbol, length;

    explicit Huffman(const uint8_t* spec) : symbol(1 << 16, 0), length(1 << 16, 0) {
        // spec: 16 code counts per length, then up to 256 symbols.
        const uint8_t* counts = spec;
        const uint8_t* symbols = spec + 16;
        uint32_t code = 0;
        int k = 0;
        for (int len = 1; len <= 16; ++len) {
            for (int i = 0; i < counts[len - 1]; ++i) {
                uint32_t lo = code << (16 - len), hi = (code + 1) << (16 - len);
                if (hi > (1u << 16) || k >= 256) {
                    return;  // an over-full table: the remaining codes never match
                }
                std::memset(&symbol[lo], symbols[k], hi - lo);
                std::memset(&length[lo], len, hi - lo);
                ++code;
                ++k;
            }
            code <<= 1;
        }
    }
};

// MSB-first bit reader over one restart segment; past its end it reads ones.
struct Bits {
    const uint8_t* data;
    int64_t size, pos = 0;
    uint64_t buffer = 0;
    int count = 0;

    void fill() {
        while (count <= 56) {
            uint64_t byte = pos < size ? data[pos] : 0xFF;
            ++pos;
            buffer |= byte << (56 - count);
            count += 8;
        }
    }
    uint32_t peek16() {
        if (count < 16) fill();
        return static_cast<uint32_t>(buffer >> 48);
    }
    void skip(int n) {
        buffer <<= n;
        count -= n;
    }
    int32_t get(int n) {
        if (count < n) fill();
        int32_t value = static_cast<int32_t>(buffer >> (64 - n));
        skip(n);
        return value;
    }
};

int32_t extend(int32_t value, int size) {
    return value < (1 << (size - 1)) ? value - (1 << size) + 1 : value;
}

// libjpeg's range limit after the IDCT: the 10-bit wrapped value maps to
// [0, 255] (jdmaster.c prepare_range_limit_table, offset by CENTERJSAMPLE).
uint8_t range_limit(int64_t x) {
    int v = static_cast<int>(x & 1023);
    if (v < 128) return static_cast<uint8_t>(v + 128);
    if (v < 512) return 255;
    if (v < 896) return 0;
    return static_cast<uint8_t>(v - 896);
}

const int kConstBits = 13, kPass1Bits = 2;

int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// One 8-point islow pass over in[0], in[stride], ... (jidctint.c), results
// before the descale into out[0..7].
void islow_1d(const int64_t* in, int stride, int64_t* out) {
    int64_t z2 = in[2 * stride], z3 = in[6 * stride];
    int64_t z1 = (z2 + z3) * 4433;                    // FIX_0_541196100
    int64_t tmp2 = z1 + z3 * -15137;                  // FIX_1_847759065
    int64_t tmp3 = z1 + z2 * 6270;                    // FIX_0_765366865
    int64_t tmp0 = (in[0] + in[4 * stride]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (in[0] - in[4 * stride]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    int64_t t0 = in[7 * stride], t1 = in[5 * stride], t2 = in[3 * stride], t3 = in[stride];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3;
    int64_t z5 = (z3 + z4) * 9633;                    // FIX_1_175875602
    t0 *= 2446;                                       // FIX_0_298631336
    t1 *= 16819;                                      // FIX_2_053119869
    t2 *= 25172;                                      // FIX_3_072711026
    t3 *= 12299;                                      // FIX_1_501321110
    z1 *= -7373;                                      // FIX_0_899976223
    z2 *= -20995;                                     // FIX_2_562915447
    z3 *= -16069;                                     // FIX_1_961570560
    z4 *= -3196;                                      // FIX_0_390180644
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;

    out[0] = tmp10 + t3;
    out[7] = tmp10 - t3;
    out[1] = tmp11 + t2;
    out[6] = tmp11 - t2;
    out[2] = tmp12 + t1;
    out[5] = tmp12 - t1;
    out[3] = tmp13 + t0;
    out[4] = tmp13 - t0;
}

// Dequantised natural-order coefficients -> 8x8 pixels at `out`.
void idct_islow(const int64_t* coef, uint8_t* out, int64_t out_stride) {
    int64_t work[64], column[8], row[8];
    for (int c = 0; c < 8; ++c) {
        islow_1d(coef + c, 8, column);
        for (int r = 0; r < 8; ++r) {
            work[r * 8 + c] = descale(column[r], kConstBits - kPass1Bits);
        }
    }
    for (int r = 0; r < 8; ++r) {
        islow_1d(work + r * 8, 1, row);
        for (int c = 0; c < 8; ++c) {
            out[r * out_stride + c] = range_limit(descale(row[c], kConstBits + kPass1Bits + 3));
        }
    }
}

// Dequantised natural-order coefficients -> 8x8 pixels at `out`. FFmpeg
// keeps the block in int16 (the DC clipped, the AC wrapped) and starts its
// DC predictor at 1024, the level shift; the row pass takes a DC-only
// shortcut and stores int16, the column pass clips to [0, 255].
void idct_simple(const int64_t* coef, uint8_t* out, int64_t out_stride) {
    int32_t block[64];
    for (int k = 1; k < 64; ++k) block[k] = static_cast<int16_t>(coef[k]);
    const int64_t dc = coef[0] + 1024;
    block[0] = dc < -32768 ? -32768 : (dc > 32767 ? 32767 : static_cast<int32_t>(dc));
    simple_idct::put(block, out, out_stride);
}

}  // namespace

// Decode one baseline scan into the pixel planes of its components.
//
// data / seg_offsets: the scan's entropy-coded bytes without byte stuffing,
//   segment s (one restart interval) at [seg_offsets[s], seg_offsets[s+1]).
// h, v: blocks per MCU of each component (1, 1 in a one-component scan).
// block_cols: blocks per row of each component's plane (plane width / 8).
// dc_specs, ac_specs: per component, 16 code counts then 256 symbols.
// quant: per component, 64 quantisation steps in natural order.
// idct: 0 for libjpeg's islow IDCT, 1 for FFmpeg's simple IDCT.
// planes: per component, the uint8 plane (block rows * 8, block_cols * 8).
// Returns 0, or -1 / -2 when no DC / AC code matches, -3 for a coefficient
// past 63, -4 when the scan ends before its last MCU, -5 for a DC magnitude
// category over 15.
extern "C" int hive_jpeg_decode_scan(
    const uint8_t* data, const int64_t* seg_offsets, int64_t num_segments,
    int32_t ncomp, const int32_t* h, const int32_t* v, const int64_t* block_cols,
    const uint8_t* dc_specs, const uint8_t* ac_specs, const int32_t* quant,
    int64_t mcu_rows, int64_t mcu_cols, int64_t restart, int32_t idct,
    uint8_t* const* planes) {
    const int kSpec = 16 + 256;
    std::vector<Huffman> dc, ac;
    dc.reserve(ncomp);
    ac.reserve(ncomp);
    for (int c = 0; c < ncomp; ++c) {
        dc.emplace_back(dc_specs + c * kSpec);
        ac.emplace_back(ac_specs + c * kSpec);
    }

    const int64_t total = mcu_rows * mcu_cols;
    int64_t mcu = 0;
    int64_t coef[64];
    for (int64_t segment = 0; mcu < total; ++segment) {
        if (segment >= num_segments) {
            return -4;
        }
        Bits bits{data + seg_offsets[segment], seg_offsets[segment + 1] - seg_offsets[segment]};
        std::vector<int32_t> prediction(ncomp, 0);
        const int64_t stop = restart ? (total < mcu + restart ? total : mcu + restart) : total;
        for (; mcu < stop; ++mcu) {
            const int64_t mrow = mcu / mcu_cols, mcol = mcu % mcu_cols;
            for (int c = 0; c < ncomp; ++c) {
                const Huffman& dct = dc[c];
                const Huffman& act = ac[c];
                const int32_t* q = quant + 64 * c;
                for (int by = 0; by < v[c]; ++by) {
                    for (int bx = 0; bx < h[c]; ++bx) {
                        std::memset(coef, 0, sizeof(coef));
                        uint32_t w = bits.peek16();
                        if (dct.length[w] == 0) return -1;
                        bits.skip(dct.length[w]);
                        int size = dct.symbol[w];
                        if (size > 15) return -5;  // libjpeg refuses such a DC table
                        if (size) prediction[c] += extend(bits.get(size), size);
                        coef[0] = static_cast<int64_t>(prediction[c]) * q[0];
                        for (int k = 1; k < 64;) {
                            w = bits.peek16();
                            if (act.length[w] == 0) return -2;
                            bits.skip(act.length[w]);
                            int symbol = act.symbol[w];
                            int run = symbol >> 4;
                            size = symbol & 15;
                            if (size == 0) {
                                if (run != 15) break;  // EOB
                                k += 16;               // ZRL
                                continue;
                            }
                            k += run;
                            if (k > 63) return -3;
                            coef[kZigzag[k]] =
                                static_cast<int64_t>(extend(bits.get(size), size)) * q[kZigzag[k]];
                            ++k;
                        }
                        const int64_t row = mrow * v[c] + by, col = mcol * h[c] + bx;
                        const int64_t stride = block_cols[c] * 8;
                        uint8_t* dest = planes[c] + row * 8 * stride + col * 8;
                        if (idct == 1) {
                            idct_simple(coef, dest, stride);
                        } else {
                            idct_islow(coef, dest, stride);
                        }
                    }
                }
            }
        }
    }
    return 0;
}

// Decode one scan of a progressive JPEG (jdphuff.c) into quantised
// coefficients: DC first (Ss = 0, Ah = 0) and refinement (Ah > 0) scans,
// AC first and refinement scans with end-of-band runs.
//
// Native counterpart of hive_tpu_torch/image_codecs.py's
// `_decode_progressive_scan`; the same segments, components and MCU grid
// as `hive_jpeg_decode_scan`, and per component an int32 array of
// (rows, block_cols[c], 64) zigzag coefficients, updated in place.
// Returns 0, or -1 when no Huffman code matches, -3 for a coefficient past
// 63, -4 when the scan ends before its last MCU, -5 for a DC magnitude
// category over 15.
extern "C" int hive_jpeg_decode_progressive_scan(
    const uint8_t* data, const int64_t* seg_offsets, int64_t num_segments,
    int32_t ncomp, const int32_t* h, const int32_t* v, const int64_t* block_cols,
    const uint8_t* dc_specs, const uint8_t* ac_specs, int64_t mcu_rows, int64_t mcu_cols,
    int64_t restart, int32_t ss, int32_t se, int32_t ah, int32_t al,
    int32_t* const* coeffs) {
    const int kSpec = 16 + 256;
    std::vector<Huffman> dc, ac;
    dc.reserve(ncomp);
    ac.reserve(ncomp);
    for (int c = 0; c < ncomp; ++c) {
        dc.emplace_back(dc_specs + c * kSpec);
        ac.emplace_back(ac_specs + c * kSpec);
    }
    const int32_t p1 = 1 << al;
    const int32_t m1 = -p1;

    const int64_t total = mcu_rows * mcu_cols;
    int64_t mcu = 0;
    for (int64_t segment = 0; mcu < total; ++segment) {
        if (segment >= num_segments) {
            return -4;
        }
        Bits bits{data + seg_offsets[segment], seg_offsets[segment + 1] - seg_offsets[segment]};
        std::vector<int32_t> prediction(ncomp, 0);
        int64_t eobrun = 0;
        const int64_t stop = restart ? (total < mcu + restart ? total : mcu + restart) : total;
        for (; mcu < stop; ++mcu) {
            const int64_t mrow = mcu / mcu_cols, mcol = mcu % mcu_cols;
            for (int c = 0; c < ncomp; ++c) {
                for (int by = 0; by < v[c]; ++by) {
                    for (int bx = 0; bx < h[c]; ++bx) {
                        const int64_t row = mrow * v[c] + by, col = mcol * h[c] + bx;
                        int32_t* block = coeffs[c] + (row * block_cols[c] + col) * 64;
                        if (ss == 0) {  // DC scans
                            if (ah == 0) {
                                uint32_t w = bits.peek16();
                                if (dc[c].length[w] == 0) return -1;
                                bits.skip(dc[c].length[w]);
                                const int size = dc[c].symbol[w];
                                if (size > 15) return -5;
                                if (size) prediction[c] += extend(bits.get(size), size);
                                block[0] = prediction[c] * p1;
                            } else if (bits.get(1)) {
                                block[0] |= p1;
                            }
                            continue;
                        }
                        if (ah == 0) {  // AC first
                            if (eobrun) {
                                --eobrun;
                                continue;
                            }
                            for (int k = ss; k <= se; ++k) {
                                uint32_t w = bits.peek16();
                                if (ac[c].length[w] == 0) return -1;
                                bits.skip(ac[c].length[w]);
                                const int symbol = ac[c].symbol[w];
                                const int run = symbol >> 4, size = symbol & 15;
                                if (size) {
                                    k += run;
                                    if (k > 63) return -3;
                                    block[k] = extend(bits.get(size), size) * p1;
                                } else if (run == 15) {
                                    k += 15;
                                } else {
                                    eobrun = (int64_t(1) << run) + (run ? bits.get(run) : 0) - 1;
                                    break;
                                }
                            }
                            continue;
                        }
                        int k = ss;  // AC refinement
                        if (eobrun == 0) {
                            for (; k <= se; ++k) {
                                uint32_t w = bits.peek16();
                                if (ac[c].length[w] == 0) return -1;
                                bits.skip(ac[c].length[w]);
                                const int symbol = ac[c].symbol[w];
                                int run = symbol >> 4;
                                const int size = symbol & 15;
                                int32_t value = 0;
                                if (size) {
                                    value = bits.get(1) ? p1 : m1;
                                } else if (run != 15) {
                                    eobrun = (int64_t(1) << run) + (run ? bits.get(run) : 0);
                                    break;
                                }
                                for (; k <= se; ++k) {
                                    int32_t& coef = block[k];
                                    if (coef != 0) {
                                        if (bits.get(1) && (coef & p1) == 0) {
                                            coef += coef >= 0 ? p1 : m1;
                                        }
                                    } else if (--run < 0) {
                                        break;
                                    }
                                }
                                if (value && k <= se) block[k] = value;
                            }
                        }
                        if (eobrun > 0) {
                            for (; k <= se; ++k) {
                                int32_t& coef = block[k];
                                if (coef != 0 && bits.get(1) && (coef & p1) == 0) {
                                    coef += coef >= 0 ? p1 : m1;
                                }
                            }
                            --eobrun;
                        }
                    }
                }
            }
        }
    }
    return 0;
}
