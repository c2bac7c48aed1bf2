// FFmpeg's 8-bit "simple" inverse DCT (libavcodec/simple_idct_template.c),
// shared by the JPEG scan decoder and the MPEG-4 Part 2 VOP decoder. Its
// x86 SIMD version (simple_idct8) gives the C version's pixels, so these
// are the pixels cv2's FFmpeg returns.
#ifndef HIVE_SIMPLE_IDCT_H_
#define HIVE_SIMPLE_IDCT_H_

#include <cstdint>

namespace simple_idct {

// Cosines x sqrt(2) x 2^14, and the pass shifts.
const int32_t kW1 = 22725, kW2 = 21407, kW3 = 19266, kW4 = 16383, kW5 = 12873, kW6 = 8867,
              kW7 = 4520;
const int kRowShift = 11, kColShift = 20;

// One 8-point pass over c[0], c[stride], ... with the even part's rounding
// in a0; the eight sums before the shift, in output order, as FFmpeg's
// unsigned arithmetic wraps them to 32 bits.
inline void pass_1d(const int32_t* c, int stride, uint32_t a0, int32_t* out) {
    const uint32_t c1 = c[stride], c2 = c[2 * stride], c3 = c[3 * stride],
                   c4 = c[4 * stride], c5 = c[5 * stride], c6 = c[6 * stride],
                   c7 = c[7 * stride];
    uint32_t a1 = a0 + kW6 * c2, a2 = a0 - kW6 * c2, a3 = a0 - kW2 * c2;
    a0 += kW2 * c2;
    const uint32_t b0 = kW1 * c1 + kW3 * c3 + kW5 * c5 + kW7 * c7;
    const uint32_t b1 = kW3 * c1 - kW7 * c3 - kW1 * c5 - kW5 * c7;
    const uint32_t b2 = kW5 * c1 - kW1 * c3 + kW7 * c5 + kW3 * c7;
    const uint32_t b3 = kW7 * c1 - kW5 * c3 + kW3 * c5 - kW1 * c7;
    a0 += kW4 * c4 + kW6 * c6;
    a1 += -kW4 * c4 - kW2 * c6;
    a2 += -kW4 * c4 + kW2 * c6;
    a3 += kW4 * c4 - kW6 * c6;
    out[0] = static_cast<int32_t>(a0 + b0);
    out[1] = static_cast<int32_t>(a1 + b1);
    out[2] = static_cast<int32_t>(a2 + b2);
    out[3] = static_cast<int32_t>(a3 + b3);
    out[4] = static_cast<int32_t>(a3 - b3);
    out[5] = static_cast<int32_t>(a2 - b2);
    out[6] = static_cast<int32_t>(a1 - b1);
    out[7] = static_cast<int32_t>(a0 - b0);
}

// The row pass, in place, over a block of int16 values held in int32: a
// DC-only shortcut, each result stored as int16.
inline void rows(int32_t* block) {
    int32_t sums[8];
    for (int r = 0; r < 8; ++r) {
        int32_t* row = block + r * 8;
        bool dc_only = true;
        for (int k = 1; k < 8; ++k) dc_only &= row[k] == 0;
        if (dc_only) {
            const int32_t v = static_cast<int16_t>(row[0] * 8);
            for (int k = 0; k < 8; ++k) row[k] = v;
            continue;
        }
        pass_1d(row, 1, kW4 * static_cast<uint32_t>(row[0]) + (1u << (kRowShift - 1)), sums);
        for (int k = 0; k < 8; ++k) row[k] = static_cast<int16_t>(sums[k] >> kRowShift);
    }
}

inline uint8_t clip_uint8(int32_t v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Natural-order int16 coefficients (in int32) -> 8x8 pixels at `out`:
// stored (idct_put) or added to the pixels there (idct_add), clipped to
// [0, 255]. `block` is overwritten.
template <bool kAdd>
inline void transform(int32_t* block, uint8_t* out, int64_t stride) {
    int32_t sums[8];
    rows(block);
    for (int c = 0; c < 8; ++c) {
        const int32_t* col = block + c;
        pass_1d(col, 8, kW4 * static_cast<uint32_t>(col[0] + (1 << (kColShift - 1)) / kW4), sums);
        for (int r = 0; r < 8; ++r) {
            const int32_t v = sums[r] >> kColShift;
            uint8_t* pixel = out + r * stride + c;
            *pixel = clip_uint8(kAdd ? *pixel + v : v);
        }
    }
}

inline void put(int32_t* block, uint8_t* out, int64_t stride) {
    transform<false>(block, out, stride);
}
inline void add(int32_t* block, uint8_t* out, int64_t stride) {
    transform<true>(block, out, stride);
}

}  // namespace simple_idct

#endif  // HIVE_SIMPLE_IDCT_H_
