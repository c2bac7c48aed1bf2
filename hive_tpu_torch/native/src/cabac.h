// The CABAC arithmetic engine that H.264 (9.3.1.2, 9.3.3.2, 9.3.4) and
// HEVC (9.3.2.5, 9.3.4.3, 9.3.5) share: one rangeTabLPS, one pair of state
// transition tables, one decoder and one encoder. Each codec keeps its own
// context initialisation and syntax (h264_decode.cpp, hevc_decode.cpp).
// The decoder reads from any bit reader with `pos` (bits) and `get(n)`, the
// encoder writes to any bit writer with `put(n, value)`. This is host code,
// not a device kernel.

#pragma once

#include <cstdint>

namespace cabac {

// rangeTabLPS[pStateIdx][qCodIRangeIdx] (Table 9-44).
const uint8_t kRangeTabLPS[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216}, {123, 150, 178, 205},
    {116, 142, 169, 195}, {111, 135, 160, 185}, {105, 128, 152, 175}, {100, 122, 144, 166},
    {95, 116, 137, 158}, {90, 110, 130, 150}, {85, 104, 123, 142}, {81, 99, 117, 135},
    {77, 94, 111, 128}, {73, 89, 105, 122}, {69, 85, 100, 116}, {66, 80, 95, 110},
    {62, 76, 90, 104}, {59, 72, 86, 99}, {56, 69, 81, 94}, {53, 65, 77, 89},
    {51, 62, 73, 85}, {48, 59, 69, 80}, {46, 56, 66, 76}, {43, 53, 63, 72},
    {41, 50, 59, 69}, {39, 48, 56, 65}, {37, 45, 54, 62}, {35, 43, 51, 59},
    {33, 41, 48, 56}, {32, 39, 46, 53}, {30, 37, 43, 50}, {29, 35, 41, 48},
    {27, 33, 39, 45}, {26, 31, 37, 43}, {24, 30, 35, 41}, {23, 28, 33, 39},
    {22, 27, 32, 37}, {21, 26, 30, 35}, {20, 24, 29, 33}, {19, 23, 27, 31},
    {18, 22, 26, 30}, {17, 21, 25, 28}, {16, 20, 23, 27}, {15, 19, 22, 25},
    {14, 18, 21, 24}, {14, 17, 20, 23}, {13, 16, 19, 22}, {12, 15, 18, 21},
    {12, 14, 17, 20}, {11, 14, 16, 19}, {11, 13, 15, 18}, {10, 12, 15, 17},
    {10, 12, 14, 16}, {9, 11, 13, 15}, {9, 11, 12, 14}, {8, 10, 12, 14},
    {8, 9, 11, 13}, {7, 9, 11, 12}, {7, 9, 10, 12}, {7, 8, 10, 11},
    {6, 8, 9, 11}, {6, 7, 9, 10}, {6, 7, 8, 9}, {2, 2, 2, 2},
};

// transIdxLPS and transIdxMPS of each pStateIdx (Table 9-45).
const uint8_t kTransIdxLPS[64] = {
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
};

const uint8_t kTransIdxMPS[64] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
    49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 62, 63,
};

// The arithmetic decoding engine (9.3.1.2, 9.3.3.2). Reading stops at
// `limit` (the slice's end plus the reader's slack): past it the engine
// reads zeros and sets `over`.
template <class Reader>
struct Decoder {
    static constexpr bool kEncode = false;
    Reader* r;
    int64_t limit;
    bool over = false;
    uint32_t range = 510, offset = 0;
    uint8_t state[1024];

    uint32_t bits(int n) {
        if (r->pos + n > limit) {
            over = true;
            return 0;
        }
        return r->get(n);
    }
    void start() {
        range = 510;
        offset = bits(9);
    }
    void renorm() {
        if (range < 256) {
            const int n = __builtin_clz(range) - 23;
            range <<= n;
            offset = (offset << n) | bits(n);
        }
    }
    int decision(int ctx, int = 0) {
        uint8_t& s = state[ctx];
        int p = s >> 1, mps = s & 1, bin;
        const uint32_t lps = kRangeTabLPS[p][(range >> 6) & 3];
        range -= lps;
        if (offset >= range) {
            bin = !mps;
            offset -= range;
            range = lps;
            if (!p) mps = !mps;
            p = kTransIdxLPS[p];
        } else {
            bin = mps;
            p = kTransIdxMPS[p];
        }
        s = static_cast<uint8_t>(p << 1 | mps);
        renorm();
        return bin;
    }
    int bypass(int = 0) {
        offset = (offset << 1) | bits(1);
        if (offset >= range) {
            offset -= range;
            return 1;
        }
        return 0;
    }
    int terminate(int = 0) {
        range -= 2;
        if (offset >= range) return 1;
        renorm();
        return 0;
    }
};

// The arithmetic encoding engine (9.3.4.2 - 9.3.4.5); `cover` counts each
// context's decisions.
template <class Writer>
struct Encoder {
    static constexpr bool kEncode = true;
    Writer* w;
    int64_t* cover = nullptr;
    uint32_t low = 0, range = 510;
    int outstanding = 0;
    bool first = true;
    uint8_t state[1024];

    void start() {
        low = 0;
        range = 510;
        outstanding = 0;
        first = true;
    }
    void put_bit(int b) {
        if (first)
            first = false;
        else
            w->put(1, b);
        for (; outstanding > 0; --outstanding) w->put(1, !b);
    }
    void renorm() {
        while (range < 256) {
            if (low < 256) {
                put_bit(0);
            } else if (low >= 512) {
                low -= 512;
                put_bit(1);
            } else {
                low -= 256;
                ++outstanding;
            }
            range <<= 1;
            low <<= 1;
        }
    }
    int decision(int ctx, int bin) {
        if (cover) ++cover[ctx];
        uint8_t& s = state[ctx];
        int p = s >> 1, mps = s & 1;
        const uint32_t lps = kRangeTabLPS[p][(range >> 6) & 3];
        range -= lps;
        if (bin != mps) {
            low += range;
            range = lps;
            if (!p) mps = !mps;
            p = kTransIdxLPS[p];
        } else {
            p = kTransIdxMPS[p];
        }
        s = static_cast<uint8_t>(p << 1 | mps);
        renorm();
        return bin;
    }
    int bypass(int bin) {
        low <<= 1;
        if (bin) low += range;
        if (low >= 1024) {
            put_bit(1);
            low -= 1024;
        } else if (low < 512) {
            put_bit(0);
        } else {
            low -= 512;
            ++outstanding;
        }
        return bin;
    }
    // A 1 ends the arithmetic code (EncodeFlush): its last bit written is
    // the rbsp_stop_one_bit, or comes before I_PCM's alignment.
    int terminate(int bin) {
        range -= 2;
        if (!bin) {
            renorm();
            return 0;
        }
        low += range;
        range = 2;
        renorm();
        put_bit((low >> 9) & 1);
        w->put(2, ((low >> 7) & 3) | 1);
        return 1;
    }
};

}  // namespace cabac
