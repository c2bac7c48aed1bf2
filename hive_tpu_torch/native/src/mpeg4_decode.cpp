// MPEG-4 Part 2 Simple Profile: one VOP (video object plane) decoded below
// its header as FFmpeg's mpeg4 decoder decodes it, so as cv2.VideoCapture
// reads an MPEG-4 Part 2 video; and the matching encode, which writes the
// test fixtures.
//
// The Python side (hive_tpu_torch/video/mpeg4.py) parses the VOS, VO, VOL,
// GOV and VOP headers, refuses what this file does not decode and holds the
// reference picture; hive_mpeg4_decode_vop takes the VOP's bytes from the
// bit after its header: the macroblock layer (MCBPC, CBPY, ac_pred_flag,
// DQUANT, not_coded, 1MV and 4MV motion vectors with median prediction),
// the TCOEF VLCs with the three escapes, intra DC sizes with the DC scaler
// tables, DC and AC prediction, H.263 inverse quantisation, FFmpeg's simple
// IDCT (simple_idct.h), half-pel motion compensation with both rounding
// types and unrestricted motion vectors, and video packets (resync markers).
// Each step follows libavcodec (mpeg4videodec.c, h263.c, mpegvideo_motion.c,
// hpeldsp.c) where the standard leaves a choice, e.g. the 4MV block clamp in
// hpel_motion and the DC store's clip. The VLC tables are those of ISO/IEC
// 14496-2 annex B; the TCOEF table's events were read back from cv2 5.0.0's
// decoder one codeword at a time.
//
// Output: the picture at its coded size (16-pixel macroblocks); the caller
// crops it. This is host code, not a device kernel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

#include "simple_idct.h"

namespace {

// ---------------------------------------------------------------------------
// Tables.
// ---------------------------------------------------------------------------

struct Code {
    uint16_t code;
    uint8_t len;
};

// The 102 TCOEF codewords (without the sign bit) and the (last, run, level)
// each stands for in the inter (H.263) and the intra (MPEG-4) table.
struct Tcoef {
    uint16_t code;
    uint8_t len, inter_last, inter_run, inter_level, intra_last, intra_run, intra_level;
};
const Tcoef kTcoef[102] = {
    {0x2, 2, 0, 0, 1, 0, 0, 1},
    {0xF, 4, 0, 0, 2, 0, 0, 3},
    {0x15, 6, 0, 0, 3, 0, 0, 6},
    {0x17, 7, 0, 0, 4, 0, 0, 9},
    {0x1F, 8, 0, 0, 5, 0, 0, 10},
    {0x25, 9, 0, 0, 6, 0, 0, 13},
    {0x24, 9, 0, 0, 7, 0, 0, 14},
    {0x21, 10, 0, 0, 8, 0, 0, 17},
    {0x20, 10, 0, 0, 9, 0, 0, 18},
    {0x7, 11, 0, 0, 10, 0, 0, 21},
    {0x6, 11, 0, 0, 11, 0, 0, 22},
    {0x20, 11, 0, 0, 12, 0, 0, 23},
    {0x6, 3, 0, 1, 1, 0, 0, 2},
    {0x14, 6, 0, 1, 2, 0, 1, 2},
    {0x1E, 8, 0, 1, 3, 0, 0, 11},
    {0xF, 10, 0, 1, 4, 0, 0, 19},
    {0x21, 11, 0, 1, 5, 0, 0, 24},
    {0x50, 12, 0, 1, 6, 0, 0, 25},
    {0xE, 4, 0, 2, 1, 0, 1, 1},
    {0x1D, 8, 0, 2, 2, 0, 0, 12},
    {0xE, 10, 0, 2, 3, 0, 0, 20},
    {0x51, 12, 0, 2, 4, 0, 0, 26},
    {0xD, 5, 0, 3, 1, 0, 0, 4},
    {0x23, 9, 0, 3, 2, 0, 0, 15},
    {0xD, 10, 0, 3, 3, 0, 1, 7},
    {0xC, 5, 0, 4, 1, 0, 0, 5},
    {0x22, 9, 0, 4, 2, 0, 4, 2},
    {0x52, 12, 0, 4, 3, 0, 0, 27},
    {0xB, 5, 0, 5, 1, 0, 2, 1},
    {0xC, 10, 0, 5, 2, 0, 2, 4},
    {0x53, 12, 0, 5, 3, 0, 1, 9},
    {0x13, 6, 0, 6, 1, 0, 0, 7},
    {0xB, 10, 0, 6, 2, 0, 3, 4},
    {0x54, 12, 0, 6, 3, 0, 6, 3},
    {0x12, 6, 0, 7, 1, 0, 0, 8},
    {0xA, 10, 0, 7, 2, 0, 4, 3},
    {0x11, 6, 0, 8, 1, 0, 3, 1},
    {0x9, 10, 0, 8, 2, 0, 8, 2},
    {0x10, 6, 0, 9, 1, 0, 4, 1},
    {0x8, 10, 0, 9, 2, 0, 5, 3},
    {0x16, 7, 0, 10, 1, 0, 1, 3},
    {0x55, 12, 0, 10, 2, 0, 1, 10},
    {0x15, 7, 0, 11, 1, 0, 2, 2},
    {0x14, 7, 0, 12, 1, 0, 7, 1},
    {0x1C, 8, 0, 13, 1, 0, 1, 4},
    {0x1B, 8, 0, 14, 1, 0, 3, 2},
    {0x21, 9, 0, 15, 1, 0, 0, 16},
    {0x20, 9, 0, 16, 1, 0, 1, 5},
    {0x1F, 9, 0, 17, 1, 0, 1, 6},
    {0x1E, 9, 0, 18, 1, 0, 2, 3},
    {0x1D, 9, 0, 19, 1, 0, 3, 3},
    {0x1C, 9, 0, 20, 1, 0, 5, 2},
    {0x1B, 9, 0, 21, 1, 0, 6, 2},
    {0x1A, 9, 0, 22, 1, 0, 7, 2},
    {0x22, 11, 0, 23, 1, 0, 1, 8},
    {0x23, 11, 0, 24, 1, 0, 9, 2},
    {0x56, 12, 0, 25, 1, 0, 2, 5},
    {0x57, 12, 0, 26, 1, 0, 7, 3},
    {0x7, 4, 1, 0, 1, 1, 0, 1},
    {0x19, 9, 1, 0, 2, 0, 11, 1},
    {0x5, 11, 1, 0, 3, 1, 0, 6},
    {0xF, 6, 1, 1, 1, 1, 1, 1},
    {0x4, 11, 1, 1, 2, 1, 0, 7},
    {0xE, 6, 1, 2, 1, 1, 2, 1},
    {0xD, 6, 1, 3, 1, 0, 5, 1},
    {0xC, 6, 1, 4, 1, 1, 0, 2},
    {0x13, 7, 1, 5, 1, 1, 5, 1},
    {0x12, 7, 1, 6, 1, 0, 6, 1},
    {0x11, 7, 1, 7, 1, 1, 3, 1},
    {0x10, 7, 1, 8, 1, 1, 4, 1},
    {0x1A, 8, 1, 9, 1, 1, 9, 1},
    {0x19, 8, 1, 10, 1, 0, 8, 1},
    {0x18, 8, 1, 11, 1, 0, 9, 1},
    {0x17, 8, 1, 12, 1, 0, 10, 1},
    {0x16, 8, 1, 13, 1, 1, 0, 3},
    {0x15, 8, 1, 14, 1, 1, 6, 1},
    {0x14, 8, 1, 15, 1, 1, 7, 1},
    {0x13, 8, 1, 16, 1, 1, 8, 1},
    {0x18, 9, 1, 17, 1, 0, 12, 1},
    {0x17, 9, 1, 18, 1, 1, 0, 4},
    {0x16, 9, 1, 19, 1, 1, 1, 2},
    {0x15, 9, 1, 20, 1, 1, 10, 1},
    {0x14, 9, 1, 21, 1, 1, 11, 1},
    {0x13, 9, 1, 22, 1, 1, 12, 1},
    {0x12, 9, 1, 23, 1, 1, 13, 1},
    {0x11, 9, 1, 24, 1, 1, 14, 1},
    {0x7, 10, 1, 25, 1, 0, 13, 1},
    {0x6, 10, 1, 26, 1, 1, 0, 5},
    {0x5, 10, 1, 27, 1, 1, 1, 3},
    {0x4, 10, 1, 28, 1, 1, 2, 2},
    {0x24, 11, 1, 29, 1, 1, 3, 2},
    {0x25, 11, 1, 30, 1, 1, 4, 2},
    {0x26, 11, 1, 31, 1, 1, 15, 1},
    {0x27, 11, 1, 32, 1, 1, 16, 1},
    {0x58, 12, 1, 33, 1, 0, 14, 1},
    {0x59, 12, 1, 34, 1, 1, 0, 8},
    {0x5A, 12, 1, 35, 1, 1, 5, 2},
    {0x5B, 12, 1, 36, 1, 1, 6, 2},
    {0x5C, 12, 1, 37, 1, 1, 17, 1},
    {0x5D, 12, 1, 38, 1, 1, 18, 1},
    {0x5E, 12, 1, 39, 1, 1, 19, 1},
    {0x5F, 12, 1, 40, 1, 1, 20, 1},
};
const int kEscape = 102;  // symbol of the escape code 0000 011
const Code kEscapeCode = {0x3, 7};

// I-VOP MCBPC: (mb_type INTRA, INTRA+Q) x 4 + cbpc; 8 is stuffing.
const Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                             {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// P-VOP MCBPC: mb_type x 4 + cbpc for INTER, INTER+Q, INTER4V, INTRA,
// INTRA+Q; 20 is stuffing.
const Code kInterMcbpc[21] = {{1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 3}, {7, 7}, {6, 7},
                              {5, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8}, {3, 5}, {4, 8},
                              {3, 8}, {3, 7}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {1, 9}};
enum { kInter = 0, kInterQ = 1, kInter4v = 2, kIntra = 3, kIntraQ = 4, kStuffing = 5 };
// CBPY by the luma coded-block pattern of an intra macroblock (inter: ^ 15).
const Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                        {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Motion vector differences by magnitude 0..32 (a sign bit follows).
const Code kMv[33] = {{1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
                      {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
                      {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
                      {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
                      {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// Intra DC sizes 0..12, luma and chroma.
const Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4},  {1, 5},
                         {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5}, {1, 6},
                           {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                               19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                               30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                               12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                               17, 18, 18, 19, 20, 21, 22, 23, 24, 25};

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,
                                    7,  15, 14, 13, 12, 19, 18, 24, 25, 32, 33, 26, 27,
                                    20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48,
                                    49, 42, 43, 36, 37, 38, 39, 44, 45, 46, 47, 50, 51,
                                    56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48,
                                  56, 57, 49, 41, 33, 26, 18, 3,  11, 4,  12, 19, 27,
                                  34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,
                                  14, 21, 29, 36, 44, 52, 60, 37, 45, 53, 61, 22, 30,
                                  7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// A prefix-code lookup on `bits` bits: symbol and length per window.
struct Vlc {
    int bits;
    std::vector<int16_t> symbol;
    std::vector<uint8_t> length;

    Vlc(const Code* codes, int n, int bits_) : bits(bits_), symbol(1 << bits_, -1),
                                               length(1 << bits_, 0) {
        for (int i = 0; i < n; ++i) add(codes[i], i);
    }
    void add(Code c, int sym) {
        if (!c.len) return;
        const uint32_t lo = uint32_t(c.code) << (bits - c.len);
        const uint32_t hi = uint32_t(c.code + 1) << (bits - c.len);
        for (uint32_t w = lo; w < hi; ++w) {
            symbol[w] = static_cast<int16_t>(sym);
            length[w] = c.len;
        }
    }
};

struct Tables {
    Vlc intra_mcbpc{kIntraMcbpc, 9, 9}, inter_mcbpc{kInterMcbpc, 21, 9}, cbpy{kCbpy, 16, 6},
        mv{kMv, 33, 12}, dc_lum{kDcLum, 13, 11}, dc_chrom{kDcChrom, 13, 12}, tcoef{nullptr, 0, 12};
    // [intra][last][run] -> largest level, [intra][last][level] -> largest
    // run (-1 where none), [intra][last][run][level] -> codeword (-1: none).
    int8_t max_level[2][2][64], max_run[2][2][64];
    int8_t index[2][2][64][32];

    Tables() {
        std::memset(max_level, 0, sizeof(max_level));
        std::memset(max_run, -1, sizeof(max_run));
        std::memset(index, -1, sizeof(index));
        for (int i = 0; i < 102; ++i) {
            tcoef.add({kTcoef[i].code, kTcoef[i].len}, i);
            for (int intra = 0; intra < 2; ++intra) {
                int last, run, level;
                event(i, intra, &last, &run, &level);
                if (level > max_level[intra][last][run]) max_level[intra][last][run] = level;
                if (run > max_run[intra][last][level]) max_run[intra][last][level] = run;
                index[intra][last][run][level] = static_cast<int8_t>(i);
            }
        }
        tcoef.add(kEscapeCode, kEscape);
    }
    static void event(int i, int intra, int* last, int* run, int* level) {
        const Tcoef& t = kTcoef[i];
        *last = intra ? t.intra_last : t.inter_last;
        *run = intra ? t.intra_run : t.inter_run;
        *level = intra ? t.intra_level : t.inter_level;
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ---------------------------------------------------------------------------
// Bits.
// ---------------------------------------------------------------------------

// How far a reader may go past a sample's end before overrun() says so.
const int kSlack = 48;
// Zero bytes after a sample: kSlack, then room for the most that the
// decoder reads between two overrun() checks (a macroblock header of at
// most 179 bits, a video packet header, an intra DC or one coefficient)
// and the 8-byte window.
const int kPadding = kSlack + 64;

// MSB-first reader over a sample followed by kPadding zero bytes.
struct Reader {
    const uint8_t* data;
    int64_t size_bits, pos;

    uint64_t window() const {
        uint64_t w;
        std::memcpy(&w, data + (pos >> 3), 8);
        return __builtin_bswap64(w) << (pos & 7);
    }
    uint32_t show(int n) const { return n ? static_cast<uint32_t>(window() >> (64 - n)) : 0; }
    uint32_t get(int n) {
        const uint32_t v = show(n);
        pos += n;
        return v;
    }
    int get1() { return static_cast<int>(get(1)); }
    int32_t sbits(int n) {  // n-bit two's complement
        const int32_t v = static_cast<int32_t>(get(n));
        return v >= (1 << (n - 1)) ? v - (1 << n) : v;
    }
    int32_t xbits(int n) {  // FFmpeg's get_xbits: top bit 0 means negative
        const int32_t v = static_cast<int32_t>(get(n));
        return v >> (n - 1) ? v : v - (1 << n) + 1;
    }
    int vlc(const Vlc& t) {
        const uint32_t w = show(t.bits);
        if (!t.length[w]) return -1;
        pos += t.length[w];
        return t.symbol[w];
    }
    void align() { pos = (pos + 7) & ~int64_t(7); }
    bool overrun() const { return pos > size_bits + 8 * kSlack; }
};

struct Writer {
    std::vector<uint8_t> bytes;
    uint64_t acc = 0;
    int count = 0;

    void put(int n, uint32_t v) {
        if (!n) return;
        acc = (acc << n) | (v & ((uint64_t(1) << n) - 1));
        count += n;
        while (count >= 8) {
            count -= 8;
            bytes.push_back(static_cast<uint8_t>(acc >> count));
        }
        acc &= (uint64_t(1) << count) - 1;
    }
    void put(Code c) { put(c.len, c.code); }
    // MPEG-4's stuffing: a zero, then ones to the byte boundary.
    void stuffing() {
        put(1, 0);
        const int k = (8 - count) & 7;
        put(k, (1u << k) - 1);
    }
};

int av_log2(uint32_t v) { return v ? 31 - __builtin_clz(v) : 0; }
int mid_pred(int a, int b, int c) {
    if (a > b) std::swap(a, b);
    return c < a ? a : (c > b ? b : c);
}
int clip(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }
int sign_extend(int v, int bits) {
    const int shift = 32 - bits;
    return static_cast<int32_t>(static_cast<uint32_t>(v) << shift) >> shift;
}
// H.263's chroma vector of a 4MV macroblock from the sum of its four.
int round_chroma(int x) {
    static const uint8_t tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    return tab[x & 15] + ((x >> 3) & ~1);
}

enum Status {
    kOk = 0,
    kSliceEnd = 1,
    kErrMcbpc = -1,
    kErrCbpy = -2,
    kErrMv = -3,
    kErrDc = -4,
    kErrAc = -5,
    kErrEscape = -6,
    kErrResync = -7,
    kErrOverrun = -8,
    kErrArguments = -9,
    kErrRange = -10,
};

// ---------------------------------------------------------------------------
// Motion compensation (hpeldsp, mpegvideo_motion.c).
// ---------------------------------------------------------------------------

struct Plane {
    const uint8_t* data;
    int stride, edge_w, edge_h;  // samples at [0, edge_w) x [0, edge_h) are real
};

// The (w x h) samples at (x, y) of `p`, replicated past its edges as
// emulated_edge_mc replicates them: a pointer into the plane when they lie
// inside it, else into `tmp`.
const uint8_t* fetch(const Plane& p, int x, int y, int w, int h, uint8_t* tmp, int* stride) {
    if (x >= 0 && y >= 0 && x + w <= p.edge_w && y + h <= p.edge_h) {
        *stride = p.stride;
        return p.data + int64_t(y) * p.stride + x;
    }
    for (int j = 0; j < h; ++j) {
        const uint8_t* row = p.data + int64_t(clip(y + j, 0, p.edge_h - 1)) * p.stride;
        for (int i = 0; i < w; ++i) tmp[j * w + i] = row[clip(x + i, 0, p.edge_w - 1)];
    }
    *stride = w;
    return tmp;
}

// put_pixels / put_no_rnd_pixels of a w x h block (w 16 or 8), half-pel
// position dxy (bit 0 x, bit 1 y), as FFmpeg's x86 hpeldsp computes them:
// the 8-wide no-rounding x2 / y2 averages are its inexact MMXEXT ones
// (put_no_rnd_pixels8_x2 / _y2: pavgb with the left sample, or the sample of
// the block's odd source row, less one, saturated), which builds use unless
// asked to be bit-exact; the 16-wide ones and the xy2 ones are exact.
// Read back from cv2 5.0.0 on fixtures of 0 next to odd samples.
void hpel(uint8_t* dst, int ds, const uint8_t* s, int ss, int w, int h, int dxy, bool no_rnd) {
    const bool inexact = w == 8;
    for (int y = 0; y < h; ++y) {
        const uint8_t* r0 = s + y * ss;
        const uint8_t* r1 = r0 + ss;
        uint8_t* d = dst + y * ds;
        switch (dxy) {
            case 0:
                std::memcpy(d, r0, w);
                break;
            case 1:
                for (int x = 0; x < w; ++x) {
                    int a = r0[x], b = r0[x + 1];
                    if (!no_rnd) {
                        d[x] = static_cast<uint8_t>((a + b + 1) >> 1);
                    } else if (inexact) {
                        d[x] = static_cast<uint8_t>(((a ? a - 1 : 0) + b + 1) >> 1);
                    } else {
                        d[x] = static_cast<uint8_t>((a + b) >> 1);
                    }
                }
                break;
            case 2:
                for (int x = 0; x < w; ++x) {
                    int a = r0[x], b = r1[x];
                    if (!no_rnd) {
                        d[x] = static_cast<uint8_t>((a + b + 1) >> 1);
                    } else if (inexact) {
                        if (y & 1) {
                            a = a ? a - 1 : 0;
                        } else {
                            b = b ? b - 1 : 0;
                        }
                        d[x] = static_cast<uint8_t>((a + b + 1) >> 1);
                    } else {
                        d[x] = static_cast<uint8_t>((a + b) >> 1);
                    }
                }
                break;
            default:
                for (int x = 0; x < w; ++x) {
                    d[x] = static_cast<uint8_t>(
                        (r0[x] + r0[x + 1] + r1[x] + r1[x + 1] + 2 - (no_rnd ? 1 : 0)) >> 2);
                }
        }
    }
}

// ---------------------------------------------------------------------------
// The macroblock layer's state, shared by the decoder and the encoder.
// ---------------------------------------------------------------------------

struct Picture {
    uint8_t* y;
    uint8_t* u;
    uint8_t* v;
};

struct Config {
    int mbw, mbh, width, height;
    int coding_type;     // 0 I-VOP, 1 P-VOP
    int qscale, fcode, rounding, intra_dc_threshold, time_increment_bits;
};

class Vop {
   public:
    Vop(const Config& c, const uint8_t* const* ref)
        : cfg(c),
          lstride(2 * c.mbw + 2),
          cstride(c.mbw + 2),
          mb_num(c.mbw * c.mbh) {
        const int lsize = (2 * c.mbh + 1) * lstride, csize = (c.mbh + 1) * cstride;
        for (int p = 0; p < 3; ++p) {
            dc[p].assign(p ? csize : lsize, 1024);
            ac[p].assign(16 * (p ? csize : lsize), 0);
        }
        mvs.assign(2 * lsize, 0);
        qtab.assign(mb_num, 0);
        // Reference pictures end at the coded size (FFmpeg's h_edge_pos /
        // v_edge_pos), past which motion compensation replicates them.
        const int w = 16 * c.mbw, h = 16 * c.mbh;
        if (ref) {
            refp[0] = {ref[0], w, w, h};
            refp[1] = {ref[1], w / 2, w / 2, h / 2};
            refp[2] = {ref[2], w / 2, w / 2, h / 2};
        }
        set_qscale(c.qscale);
        prefix_length = c.coding_type ? 15 + c.fcode : 16;
        mb_num_bits = av_log2(mb_num - 1) + 1;
    }

    const Config cfg;
    const int lstride, cstride, mb_num;
    int prefix_length, mb_num_bits;
    Plane refp[3];
    std::vector<int16_t> dc[3], ac[3], mvs;
    std::vector<int8_t> qtab;
    int mb_x = 0, mb_y = 0, resync_mb_x = 0, resync_mb_y = 0;
    bool first_slice_line = true;
    int qscale = 1, y_dc_scale = 8, c_dc_scale = 8;
    // The current macroblock.
    bool intra = false, ac_pred = false, four_mv = false;
    int mv[4][2] = {};
    int16_t block[6][64];
    int last_index[6];

    void set_qscale(int q) {
        qscale = clip(q, 1, 31);
        y_dc_scale = kYDcScale[qscale];
        c_dc_scale = kCDcScale[qscale];
    }

    // Index of block n of the current macroblock in the luma (n < 4) or
    // chroma grid, which hold a border row above and columns either side.
    int bidx(int n) const {
        if (n < 4) return (2 * mb_y + (n >> 1) + 1) * lstride + 2 * mb_x + (n & 1) + 1;
        return (mb_y + 1) * cstride + mb_x + 1;
    }
    int plane(int n) const { return n < 4 ? 0 : n - 3; }
    int wrap(int n) const { return n < 4 ? lstride : cstride; }

    // ff_mpeg4_pred_dc: the direction (0 left, 1 top) and the prediction of
    // block n's DC; stores level * scale (clipped) as the block's DC.
    int dc_prediction(int n, int* dir) {
        const int scale = n < 4 ? y_dc_scale : c_dc_scale;
        const int16_t* v = dc[plane(n)].data() + bidx(n);
        const int w = wrap(n);
        int a = v[-1], b = v[-1 - w], c = v[-w];
        if (first_slice_line && n != 3) {
            if (n != 2) b = c = 1024;
            if (n != 1 && mb_x == resync_mb_x) b = a = 1024;
        }
        if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) {
            if (n == 0 || n == 4 || n == 5) b = 1024;
        }
        int pred;
        if (std::abs(a - b) < std::abs(b - c)) {
            pred = c;
            *dir = 1;
        } else {
            pred = a;
            *dir = 0;
        }
        return (pred + (scale >> 1)) / scale;
    }
    void store_dc(int n, int level) {
        const int scale = n < 4 ? y_dc_scale : c_dc_scale;
        level *= scale;
        if (level & ~2047) level = level < 0 ? 0 : 2047;
        dc[plane(n)][bidx(n)] = static_cast<int16_t>(level);
    }

    // ff_mpeg4_pred_ac's prediction of block n's first column (dir 0, from
    // the left, at natural positions 8i) or first row (dir 1, from the top,
    // at positions i), i = 1..7, rescaled when the neighbour's qscale differs.
    void ac_prediction(int n, int dir, int32_t pred[8]) const {
        const int16_t* v = ac[plane(n)].data() + 16 * bidx(n);
        if (dir == 0) {
            v -= 16;
            const int q = mb_x ? qtab[mb_y * cfg.mbw + mb_x - 1] : 0;
            const bool same = mb_x == 0 || qscale == q || n == 1 || n == 3;
            for (int i = 1; i < 8; ++i) pred[i] = same ? v[i] : rounded_div(v[i] * q, qscale);
        } else {
            v -= 16 * wrap(n);
            const int q = mb_y ? qtab[(mb_y - 1) * cfg.mbw + mb_x] : 0;
            const bool same = mb_y == 0 || qscale == q || n == 2 || n == 3;
            for (int i = 1; i < 8; ++i) {
                pred[i] = same ? v[i + 8] : rounded_div(v[i + 8] * q, qscale);
            }
        }
    }
    void store_ac(int n, const int16_t* blk) {
        int16_t* v = ac[plane(n)].data() + 16 * bidx(n);
        for (int i = 1; i < 8; ++i) {
            v[i] = blk[i << 3];
            v[8 + i] = blk[i];
        }
    }

    int16_t* mot(int idx) { return &mvs[2 * idx]; }

    // ff_h263_pred_motion for block `block` (0 for a 1MV macroblock).
    void pred_motion(int blk, int* px, int* py) {
        static const int off[4] = {2, 1, 1, -1};
        const int w = lstride, idx = bidx(blk);
        int16_t* a = mot(idx - 1);
        if (first_slice_line && blk < 3) {
            if (blk == 0) {
                if (mb_x == resync_mb_x) {
                    *px = *py = 0;
                } else if (mb_x + 1 == resync_mb_x) {
                    const int16_t* c = mot(idx + off[0] - w);
                    if (mb_x == 0) {
                        *px = c[0];
                        *py = c[1];
                    } else {
                        *px = mid_pred(a[0], 0, c[0]);
                        *py = mid_pred(a[1], 0, c[1]);
                    }
                } else {
                    *px = a[0];
                    *py = a[1];
                }
            } else if (blk == 1) {
                if (mb_x + 1 == resync_mb_x) {
                    const int16_t* c = mot(idx + off[1] - w);
                    *px = mid_pred(a[0], 0, c[0]);
                    *py = mid_pred(a[1], 0, c[1]);
                } else {
                    *px = a[0];
                    *py = a[1];
                }
            } else {
                const int16_t* b = mot(idx - w);
                const int16_t* c = mot(idx + off[2] - w);
                if (mb_x == resync_mb_x) a[0] = a[1] = 0;
                *px = mid_pred(a[0], b[0], c[0]);
                *py = mid_pred(a[1], b[1], c[1]);
            }
        } else {
            const int16_t* b = mot(idx - w);
            const int16_t* c = mot(idx + off[blk] - w);
            *px = mid_pred(a[0], b[0], c[0]);
            *py = mid_pred(a[1], b[1], c[1]);
        }
    }

    // After a macroblock: an inter macroblock's DC and AC predictors are
    // reset (ff_h263_clean_intra_table_entries); motion vectors are stored
    // (ff_h263_update_motion_val; 4MV stored each as it was read); the
    // macroblock's qscale is kept for AC prediction.
    void finish_mb() {
        if (!intra) {
            for (int n = 0; n < 6; ++n) {
                dc[plane(n)][bidx(n)] = 1024;
                std::memset(&ac[plane(n)][16 * bidx(n)], 0, 16 * sizeof(int16_t));
            }
        }
        if (!four_mv) {
            for (int n = 0; n < 4; ++n) {
                int16_t* m = mot(bidx(n));
                m[0] = static_cast<int16_t>(intra ? 0 : mv[0][0]);
                m[1] = static_cast<int16_t>(intra ? 0 : mv[0][1]);
            }
        }
        qtab[mb_y * cfg.mbw + mb_x] = static_cast<int8_t>(qscale);
    }

    // A new video packet at the current macroblock (ff_mpeg4_clean_buffers
    // and decode_slice's set-up).
    void start_packet() {
        const int l = (2 * mb_y) * lstride + 2 * mb_x;             // luma (2y-1, 2x-1)
        std::memset(&ac[0][16 * l], 0, (lstride * 2 + 1) * 16 * sizeof(int16_t));
        const int c = mb_y * cstride + mb_x;                        // chroma (y-1, x-1)
        for (int p = 1; p < 3; ++p) {
            std::memset(&ac[p][16 * c], 0, (cstride + 1) * 16 * sizeof(int16_t));
        }
        resync_mb_x = mb_x;
        resync_mb_y = mb_y;
        first_slice_line = true;
    }

    // The prediction of the current macroblock from the reference
    // (ff_mpv_motion: mpeg_motion for 1MV, hpel_motion and
    // chroma_4mv_motion for 4MV).
    void motion(const Picture& out) {
        const int ls = 16 * cfg.mbw, cs = 8 * cfg.mbw;
        uint8_t* dy = out.y + int64_t(16 * mb_y) * ls + 16 * mb_x;
        uint8_t* du = out.u + int64_t(8 * mb_y) * cs + 8 * mb_x;
        uint8_t* dv = out.v + int64_t(8 * mb_y) * cs + 8 * mb_x;
        const bool no_rnd = cfg.rounding != 0;
        uint8_t tmp[17 * 17];
        int ss;
        if (!four_mv) {
            const int mx = mv[0][0], my = mv[0][1];
            const int dxy = ((my & 1) << 1) | (mx & 1);
            const int sx = 16 * mb_x + (mx >> 1), sy = 16 * mb_y + (my >> 1);
            const uint8_t* s = fetch(refp[0], sx, sy, 17, 17, tmp, &ss);
            hpel(dy, ls, s, ss, 16, 16, dxy, no_rnd);
            const int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
            for (int p = 1; p < 3; ++p) {
                s = fetch(refp[p], sx >> 1, sy >> 1, 9, 9, tmp, &ss);
                hpel(p == 1 ? du : dv, cs, s, ss, 8, 8, uvdxy, no_rnd);
            }
            return;
        }
        int sum_x = 0, sum_y = 0;
        for (int i = 0; i < 4; ++i) {
            const int mx = mv[i][0], my = mv[i][1];
            int sx = 16 * mb_x + (i & 1) * 8 + (mx >> 1);
            int sy = 16 * mb_y + (i >> 1) * 8 + (my >> 1);
            int dxy = 0;
            sx = clip(sx, -16, cfg.width);
            if (sx != cfg.width) dxy |= mx & 1;
            sy = clip(sy, -16, cfg.height);
            if (sy != cfg.height) dxy |= (my & 1) << 1;
            const uint8_t* s = fetch(refp[0], sx, sy, 9, 9, tmp, &ss);
            hpel(dy + (i >> 1) * 8 * ls + (i & 1) * 8, ls, s, ss, 8, 8, dxy, no_rnd);
            sum_x += mx;
            sum_y += my;
        }
        int mx = round_chroma(sum_x), my = round_chroma(sum_y);
        int dxy = ((my & 1) << 1) | (mx & 1);
        mx >>= 1;
        my >>= 1;
        int sx = clip(8 * mb_x + mx, -8, cfg.width >> 1);
        if (sx == (cfg.width >> 1)) dxy &= ~1;
        int sy = clip(8 * mb_y + my, -8, cfg.height >> 1);
        if (sy == (cfg.height >> 1)) dxy &= ~2;
        for (int p = 1; p < 3; ++p) {
            const uint8_t* s = fetch(refp[p], sx, sy, 9, 9, tmp, &ss);
            hpel(p == 1 ? du : dv, cs, s, ss, 8, 8, dxy, no_rnd);
        }
    }

    // The current macroblock's pixels: an intra macroblock's blocks
    // dequantised (dct_unquantize_h263_intra) and put, an inter one's
    // prediction plus its coded blocks' residues.
    void reconstruct(const Picture& out) {
        const int ls = 16 * cfg.mbw, cs = 8 * cfg.mbw;
        int32_t coef[64];
        if (!intra) motion(out);
        const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        for (int n = 0; n < 6; ++n) {
            uint8_t* dst = n < 4 ? out.y + int64_t(16 * mb_y + 8 * (n >> 1)) * ls + 16 * mb_x +
                                       8 * (n & 1)
                                 : (n == 4 ? out.u : out.v) + int64_t(8 * mb_y) * cs + 8 * mb_x;
            const int stride = n < 4 ? ls : cs;
            int16_t* b = block[n];
            if (intra) {
                b[0] = static_cast<int16_t>(b[0] * (n < 4 ? y_dc_scale : c_dc_scale));
                for (int i = 1; i < 64; ++i) {
                    const int level = b[i];
                    if (level) b[i] = static_cast<int16_t>(level < 0 ? level * qmul - qadd
                                                                     : level * qmul + qadd);
                }
                for (int i = 0; i < 64; ++i) coef[i] = b[i];
                simple_idct::put(coef, dst, stride);
            } else if (last_index[n] >= 0) {
                for (int i = 0; i < 64; ++i) coef[i] = b[i];
                simple_idct::add(coef, dst, stride);
            }
        }
    }
};

// ---------------------------------------------------------------------------
// The decoder (mpeg4videodec.c's mpeg4_decode_mb and mpeg4_decode_block,
// h263dec.c's decode_slice).
// ---------------------------------------------------------------------------

class Decoder : public Vop {
   public:
    Decoder(const Config& c, const uint8_t* const* ref, Reader& r) : Vop(c, ref), rd(r) {}
    Reader& rd;

    // One block into block[n]: its last scan index, or an error.
    int decode_block(int n, bool coded, bool use_dc_vlc) {
        const Tables& t = tables();
        int16_t* b = block[n];
        int i, qmul, qadd, dir = 0;
        const uint8_t* scan = kZigzag;
        if (rd.overrun()) return kErrOverrun;
        if (intra) {
            if (use_dc_vlc) {
                const int size = rd.vlc(n < 4 ? t.dc_lum : t.dc_chrom);
                if (size < 0 || size > 9) return kErrDc;
                int level = 0;
                if (size) {
                    level = rd.xbits(size);
                    if (size > 8) rd.get1();  // marker
                }
                level += dc_prediction(n, &dir);
                store_dc(n, level);
                b[0] = static_cast<int16_t>(level);
                i = 0;
            } else {
                i = -1;
                store_dc(n, dc_prediction(n, &dir));
            }
            if (ac_pred) scan = dir == 0 ? kAltVertical : kAltHorizontal;
            qmul = 1;
            qadd = 0;
        } else {
            i = -1;
            if (!coded) return -1;
            qmul = qscale << 1;
            qadd = (qscale - 1) | 1;
        }
        const int table = intra ? 1 : 0;
        while (coded) {
            if (rd.overrun()) return kErrOverrun;
            int sym = rd.vlc(t.tcoef);
            if (sym < 0) return kErrAc;
            int last, run, level;
            if (sym == kEscape) {
                const uint32_t c = rd.show(2);
                if (c == 3) {                                   // third escape
                    rd.pos += 2;
                    last = rd.get1();
                    run = static_cast<int>(rd.get(6));
                    if (!rd.get1()) return kErrEscape;
                    level = rd.sbits(12);
                    if (!rd.get1()) return kErrEscape;
                    level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                    if (static_cast<unsigned>(level + 2048) > 4095) {
                        level = level < 0 ? -2048 : 2047;
                    }
                    i += run + 1;
                } else {
                    rd.pos += c == 2 ? 2 : 1;
                    sym = rd.vlc(t.tcoef);
                    if (sym < 0 || sym == kEscape) return kErrAc;
                    Tables::event(sym, table, &last, &run, &level);
                    if (c == 2) {                               // second escape
                        i += run + 1 + t.max_run[table][last][level] + 1;
                        level = level * qmul + qadd;
                    } else {                                    // first escape
                        i += run + 1;
                        level = (level + t.max_level[table][last][run]) * qmul + qadd;
                    }
                    if (rd.get1()) level = -level;
                }
            } else {
                Tables::event(sym, table, &last, &run, &level);
                i += run + 1;
                level = level * qmul + qadd;
                if (rd.get1()) level = -level;
            }
            if (last) {
                if (i & ~63) return kErrAc;
                b[scan[i]] = static_cast<int16_t>(level);
                break;
            }
            if (i > 62) return kErrAc;
            b[scan[i]] = static_cast<int16_t>(level);
        }
        if (intra) {
            if (!use_dc_vlc) {
                int dummy;
                const int level = b[0] + dc_prediction(n, &dummy);
                store_dc(n, level);
                b[0] = static_cast<int16_t>(level);
                if (i < 0) i = 0;
            }
            int32_t pred[8];
            if (ac_pred) {
                ac_prediction(n, dir, pred);
                for (int k = 1; k < 8; ++k) {
                    const int pos = dir == 0 ? k << 3 : k;
                    b[pos] = static_cast<int16_t>(b[pos] + pred[k]);
                }
                i = 63;
            }
            store_ac(n, b);
        }
        return i;
    }

    // mpeg4_is_resync after a macroblock: the number of the macroblock a
    // resync marker (or the VOP's final stuffing) starts, or 0.
    int is_resync() {
        int64_t bits_count = rd.pos;
        uint32_t v = rd.show(16);
        const int type = cfg.coding_type ? 2 : 1;  // AV_PICTURE_TYPE_P, _I
        while (v <= 0xFF && !rd.overrun()) {
            if ((v >> (8 - type)) != 1) break;
            rd.pos += 8 + type;
            bits_count += 8 + type;
            v = rd.show(16);
        }
        if (bits_count + 8 >= rd.size_bits) {
            v >>= 8;
            v |= 0x7F >> (7 - (bits_count & 7));
            if (v == 0x7F) return mb_num;
        } else {
            static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                               0x7000, 0x6000, 0x4000, 0x0000};
            if (v == prefix[bits_count & 7]) {
                const int64_t saved = rd.pos;
                rd.pos += 1;
                rd.align();
                int len = 0;
                while (len < 32 && !rd.get1()) ++len;
                int num = static_cast<int>(rd.get(mb_num_bits));
                if (!num || num > mb_num || rd.pos + 6 > rd.size_bits) num = -1;
                rd.pos = saved;
                if (len >= prefix_length) return num;
            }
        }
        return 0;
    }

    int decode_mb() {
        const Tables& t = tables();
        static const int quant_tab[4] = {-1, -2, 1, 2};
        int cbpc, cbp, dquant;
        for (int n = 0; n < 6; ++n) {
            std::memset(block[n], 0, sizeof(block[n]));
            last_index[n] = -1;
        }
        ac_pred = false;
        four_mv = false;
        if (cfg.coding_type) {
            do {
                if (rd.get1()) {                                // not_coded
                    intra = false;
                    mv[0][0] = mv[0][1] = 0;
                    return end_mb();
                }
                if (rd.overrun()) return kErrOverrun;
                cbpc = rd.vlc(t.inter_mcbpc);
                if (cbpc < 0) return kErrMcbpc;
            } while (cbpc == 20);
            const int type = cbpc >> 2;
            cbpc &= 3;
            dquant = type == kInterQ || type == kIntraQ;
            intra = type >= kIntra;
            if (!intra) {
                int cbpy = rd.vlc(t.cbpy);
                if (cbpy < 0) return kErrCbpy;
                cbp = cbpc | ((cbpy ^ 15) << 2);
                if (dquant) set_qscale(qscale + quant_tab[rd.get(2)]);
                four_mv = type == kInter4v;
                for (int k = 0; k < (four_mv ? 4 : 1); ++k) {
                    int px, py;
                    pred_motion(four_mv ? k : 0, &px, &py);
                    const int mx = decode_motion(px), my = decode_motion(py);
                    if (mx >= 0xFFFF || my >= 0xFFFF) return kErrMv;
                    mv[k][0] = mx;
                    mv[k][1] = my;
                    if (four_mv) {
                        int16_t* m = mot(bidx(k));
                        m[0] = static_cast<int16_t>(mx);
                        m[1] = static_cast<int16_t>(my);
                    }
                }
                for (int n = 0; n < 6; ++n) {
                    const int r = decode_block(n, (cbp << n) & 32, false);
                    if (r < -1) return r;
                    last_index[n] = r;
                }
                return end_mb();
            }
        } else {
            do {
                if (rd.overrun()) return kErrOverrun;
                cbpc = rd.vlc(t.intra_mcbpc);
                if (cbpc < 0) return kErrMcbpc;
            } while (cbpc == 8);
            dquant = cbpc & 4;
            cbpc &= 3;
            intra = true;
        }
        ac_pred = rd.get1();
        const int cbpy = rd.vlc(t.cbpy);
        if (cbpy < 0) return kErrCbpy;
        cbp = cbpc | (cbpy << 2);
        const bool use_dc_vlc = qscale < cfg.intra_dc_threshold;
        if (dquant) set_qscale(qscale + quant_tab[rd.get(2)]);
        for (int n = 0; n < 6; ++n) {
            const int r = decode_block(n, (cbp << n) & 32, use_dc_vlc);
            if (r < -1) return r;
            last_index[n] = r;
        }
        return end_mb();
    }

    int decode_motion(int pred) {
        const int code = rd.vlc(tables().mv);
        if (code == 0) return pred;
        if (code < 0) return 0xFFFF;
        const int sign = rd.get1();
        const int shift = cfg.fcode - 1;
        int val = code;
        if (shift) {
            val = (val - 1) << shift;
            val |= static_cast<int>(rd.get(shift));
            ++val;
        }
        if (sign) val = -val;
        return sign_extend(val + pred, 5 + cfg.fcode);
    }

    int end_mb() {
        const int next = is_resync();
        if (next && mb_x + mb_y * cfg.mbw + 1 >= next) return kSliceEnd;
        return kOk;
    }

    // ff_mpeg4_decode_video_packet_header, after the stuffing.
    int packet_header() {
        int len = 0;
        while (len < 32 && !rd.get1()) ++len;
        if (len != prefix_length) return kErrResync;
        const int num = static_cast<int>(rd.get(mb_num_bits));
        if (num >= mb_num || !num) return kErrResync;
        if (num != mb_y * cfg.mbw + mb_x) return kErrResync;  // a lost packet: not decoded
        const int q = static_cast<int>(rd.get(5));
        if (q) set_qscale(q);
        if (rd.get1()) {                                        // header_extension_code
            while (rd.get1()) {
                if (rd.overrun()) return kErrOverrun;
            }
            rd.get1();                                          // marker
            rd.get(cfg.time_increment_bits);
            rd.get1();                                          // marker
            rd.get(2);                                          // vop_coding_type
            rd.get(3);                                          // intra_dc_vlc_thr, ignored
            if (cfg.coding_type) rd.get(3);                     // vop_fcode_forward
        }
        return kOk;
    }

    int run(const Picture& out) {
        for (;;) {
            bool slice_end = false;
            while (mb_y < cfg.mbh && !slice_end) {
                while (mb_x < cfg.mbw) {
                    if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = false;
                    const int r = decode_mb();
                    if (r < 0) return r;
                    if (rd.overrun()) return kErrOverrun;
                    finish_mb();
                    reconstruct(out);
                    ++mb_x;
                    if (r == kSliceEnd) {
                        slice_end = true;
                        break;
                    }
                }
                if (mb_x >= cfg.mbw) {
                    mb_x = 0;
                    ++mb_y;
                }
            }
            if (mb_y >= cfg.mbh) return kOk;
            // ff_h263_resync: the stuffing, then a video packet header.
            rd.pos += 1;
            rd.align();
            if (rd.show(16) != 0) return kErrResync;
            const int r = packet_header();
            if (r < 0) return r;
            start_packet();
        }
    }
};

// ---------------------------------------------------------------------------
// The encoder: the same macroblock layer written, for test fixtures.
// ---------------------------------------------------------------------------

// The 8x8 forward DCT in double precision (the inverse of the IDCT's
// scale), rounded to the nearest integer.
void fdct(const int* in, int* out) {
    struct Cosines {
        double c[8][8];
        Cosines() {
            for (int u = 0; u < 8; ++u) {
                for (int x = 0; x < 8; ++x) {
                    c[u][x] = (u ? 0.5 : 0.5 / std::sqrt(2.0)) *
                              std::cos((2 * x + 1) * u * 3.14159265358979323846 / 16.0);
                }
            }
        }
    };
    static const Cosines table;  // built once, thread-safely
    const auto& cosines = table.c;
    double tmp[64];
    for (int y = 0; y < 8; ++y) {
        for (int u = 0; u < 8; ++u) {
            double s = 0;
            for (int x = 0; x < 8; ++x) s += cosines[u][x] * in[y * 8 + x];
            tmp[y * 8 + u] = s;
        }
    }
    for (int v = 0; v < 8; ++v) {
        for (int u = 0; u < 8; ++u) {
            double s = 0;
            for (int y = 0; y < 8; ++y) s += cosines[v][y] * tmp[y * 8 + u];
            out[v * 8 + u] = static_cast<int>(std::lround(s));
        }
    }
}

enum Mode { kModeInter = 0, kModeInter4v = 1, kModeIntra = 2, kModeNotCoded = 3 };

class Encoder : public Vop {
   public:
    Encoder(const Config& c, const uint8_t* const* ref, const uint8_t* const* src)
        : Vop(c, ref) {
        for (int p = 0; p < 3; ++p) source[p] = src[p];
    }
    const uint8_t* source[3];
    Writer w;
    // What was written: escapes of the first, second and third kind,
    // macroblocks with DQUANT, intra, 4MV, not_coded and AC-predicted
    // macroblocks, video packets after the first.
    int64_t stats[9] = {};

    // Block n of the current macroblock of `planes` (strides of the coded size).
    void pixels(const uint8_t* const* planes, int n, int* out) const {
        const int ls = 16 * cfg.mbw, cs = 8 * cfg.mbw;
        const uint8_t* s = n < 4 ? planes[0] + int64_t(16 * mb_y + 8 * (n >> 1)) * ls +
                                       16 * mb_x + 8 * (n & 1)
                                 : planes[n - 3] + int64_t(8 * mb_y) * cs + 8 * mb_x;
        const int stride = n < 4 ? ls : cs;
        for (int y = 0; y < 8; ++y) {
            for (int x = 0; x < 8; ++x) out[y * 8 + x] = s[y * stride + x];
        }
    }

    // (last, run, level) events of a block's coefficients in scan order from
    // `start`, each as its VLC, an escape of the first, second or third kind.
    void write_block(const int* coef, const uint8_t* scan, int start, int table) {
        const Tables& t = tables();
        int prev = start - 1, count = 0;
        for (int k = start; k < 64; ++k) count += coef[scan[k]] != 0;
        for (int k = start; k < 64; ++k) {
            const int level = coef[scan[k]];
            if (!level) continue;
            const int last = --count == 0;
            const int run = k - prev - 1;
            prev = k;
            const int mag = std::abs(level), sign = level < 0;
            if (mag < 32 && t.index[table][last][run][mag] >= 0) {
                w.put({kTcoef[t.index[table][last][run][mag]].code,
                       kTcoef[t.index[table][last][run][mag]].len});
                w.put(1, sign);
                continue;
            }
            w.put(kEscapeCode);
            const int lmax = t.max_level[table][last][run];
            if (lmax && mag - lmax < 32 && t.index[table][last][run][mag - lmax] >= 0) {
                const Tcoef& c = kTcoef[t.index[table][last][run][mag - lmax]];
                w.put(1, 0);
                w.put(c.len, c.code);
                w.put(1, sign);
                ++stats[0];
                continue;
            }
            const int rmax = mag < 64 ? t.max_run[table][last][mag] : -1;
            if (rmax >= 0 && run - rmax - 1 >= 0 &&
                t.index[table][last][run - rmax - 1][mag] >= 0) {
                const Tcoef& c = kTcoef[t.index[table][last][run - rmax - 1][mag]];
                w.put(2, 2);
                w.put(c.len, c.code);
                w.put(1, sign);
                ++stats[1];
                continue;
            }
            w.put(2, 3);
            w.put(1, last);
            w.put(6, run);
            w.put(1, 1);
            w.put(12, static_cast<uint32_t>(level) & 0xFFF);
            w.put(1, 1);
            ++stats[2];
        }
    }

    void write_motion(int val, int pred) {
        const int f = cfg.fcode, shift = f - 1;
        int delta = sign_extend(val - pred, 5 + f);
        if (!delta) {
            w.put(kMv[0]);
            return;
        }
        const int sign = delta < 0, mag = std::abs(delta);
        const int code = ((mag - 1) >> shift) + 1;
        w.put(kMv[code]);
        w.put(1, sign);
        if (shift) w.put(shift, (mag - 1) & ((1 << shift) - 1));
    }

    int encode_mb(int mode, int want_q, const int* mvs_in, int ac_mode) {
        static const int dquant_code[5] = {1, 0, -1, 2, 3};  // by delta + 2; -1: none
        int coef[6][64];
        for (int n = 0; n < 6; ++n) last_index[n] = -1;
        four_mv = false;
        ac_pred = false;
        if (cfg.coding_type) {
            if (mode == kModeNotCoded) {
                ++stats[6];
                w.put(1, 1);
                intra = false;
                mv[0][0] = mv[0][1] = 0;
                return kOk;
            }
            w.put(1, 0);
        } else {
            mode = kModeIntra;
        }
        intra = mode == kModeIntra;
        four_mv = mode == kModeInter4v;
        int delta = four_mv ? 0 : clip(want_q, 1, 31) - qscale;
        delta = clip(delta, -2, 2);
        set_qscale(qscale + delta);
        const int qmul = qscale << 1, qadd = (qscale - 1) | 1;
        const int limit = (2047 - qadd) / qmul;
        int cbp = 0;
        int dirs[6];
        int32_t preds[6][8];
        if (intra) {
            for (int n = 0; n < 6; ++n) {
                int px[64], f[64];
                pixels(source, n, px);
                fdct(px, f);
                const int scale = n < 4 ? y_dc_scale : c_dc_scale;
                const int dc_level = clip((f[0] + (scale >> 1)) / scale, 0, 2047 / scale);
                coef[n][0] = dc_level - dc_prediction(n, &dirs[n]);
                store_dc(n, dc_level);
                int16_t levels[64] = {};
                for (int k = 1; k < 64; ++k) {
                    const int m = std::min(std::abs(f[k]) / qmul, limit);
                    coef[n][k] = f[k] < 0 ? -m : m;
                    levels[k] = static_cast<int16_t>(coef[n][k]);
                }
                ac_prediction(n, dirs[n], preds[n]);
                store_ac(n, levels);
            }
            if (ac_mode == 2) {
                int score = 0;
                for (int n = 0; n < 6; ++n) {
                    for (int k = 1; k < 8; ++k) {
                        const int pos = dirs[n] == 0 ? k << 3 : k;
                        score += std::abs(coef[n][pos]) - std::abs(coef[n][pos] - preds[n][k]);
                    }
                }
                ac_pred = score > 0;
            } else {
                ac_pred = ac_mode == 1;
            }
            for (int n = 0; n < 6; ++n) {
                if (ac_pred) {
                    for (int k = 1; k < 8; ++k) {
                        const int pos = dirs[n] == 0 ? k << 3 : k;
                        coef[n][pos] -= preds[n][k];
                        if (std::abs(coef[n][pos]) > 2047) return kErrRange;
                    }
                }
                for (int k = 1; k < 64; ++k) {
                    if (coef[n][k]) {
                        cbp |= 32 >> n;
                        break;
                    }
                }
            }
        } else {
            for (int k = 0; k < (four_mv ? 4 : 1); ++k) {
                mv[k][0] = mvs_in[2 * k];
                mv[k][1] = mvs_in[2 * k + 1];
            }
            uint8_t py_[256], pu_[64], pv_[64];
            predict(py_, pu_, pv_);
            for (int n = 0; n < 6; ++n) {
                int px[64], f[64];
                pixels(source, n, px);
                const uint8_t* p = n < 4 ? py_ + 8 * (n >> 1) * 16 + 8 * (n & 1)
                                         : (n == 4 ? pu_ : pv_);
                const int ps = n < 4 ? 16 : 8;
                for (int y = 0; y < 8; ++y) {
                    for (int x = 0; x < 8; ++x) px[y * 8 + x] -= p[y * ps + x];
                }
                fdct(px, f);
                for (int k = 0; k < 64; ++k) {
                    const int m = std::min(std::max(std::abs(f[k]) - qscale / 2, 0) / qmul, limit);
                    coef[n][k] = f[k] < 0 ? -m : m;
                    if (m) cbp |= 32 >> n;
                }
            }
        }

        const int cbpc = cbp & 3, cbpy = cbp >> 2;
        if (!cfg.coding_type) {
            w.put(kIntraMcbpc[(delta ? 4 : 0) + cbpc]);
        } else {
            const int type = intra ? (delta ? kIntraQ : kIntra)
                                   : (four_mv ? kInter4v : (delta ? kInterQ : kInter));
            w.put(kInterMcbpc[type * 4 + cbpc]);
        }
        stats[3] += delta != 0;
        stats[4] += intra;
        stats[5] += four_mv;
        stats[7] += ac_pred;
        if (intra) w.put(1, ac_pred);
        w.put(kCbpy[intra ? cbpy : cbpy ^ 15]);
        if (delta) w.put(2, dquant_code[delta + 2]);
        if (!intra) {
            for (int k = 0; k < (four_mv ? 4 : 1); ++k) {
                int px, py;
                pred_motion(four_mv ? k : 0, &px, &py);
                write_motion(mv[k][0], px);
                write_motion(mv[k][1], py);
                if (four_mv) {
                    int16_t* m = mot(bidx(k));
                    m[0] = static_cast<int16_t>(mv[k][0]);
                    m[1] = static_cast<int16_t>(mv[k][1]);
                }
            }
        }
        for (int n = 0; n < 6; ++n) {
            if (intra) {
                const int diff = coef[n][0];
                const int size = diff ? 32 - __builtin_clz(std::abs(diff)) : 0;
                w.put(n < 4 ? kDcLum[size] : kDcChrom[size]);
                if (size) {
                    w.put(size, diff > 0 ? diff : diff + (1 << size) - 1);
                    if (size > 8) w.put(1, 1);
                }
                if (cbp & (32 >> n)) {
                    const uint8_t* scan = ac_pred ? (dirs[n] == 0 ? kAltVertical : kAltHorizontal)
                                                  : kZigzag;
                    write_block(coef[n], scan, 1, 1);
                }
            } else if (cbp & (32 >> n)) {
                write_block(coef[n], kZigzag, 0, 0);
            }
        }
        return kOk;
    }

    // The inter prediction of the current macroblock, through the decoder's
    // own motion compensation into a one-macroblock scratch picture.
    void predict(uint8_t* py, uint8_t* pu, uint8_t* pv) {
        const int ls = 16 * cfg.mbw, cs = 8 * cfg.mbw;
        std::vector<uint8_t>& y = scratch[0];
        std::vector<uint8_t>& u = scratch[1];
        std::vector<uint8_t>& v = scratch[2];
        if (y.empty()) {
            y.assign(size_t(ls) * 16 * cfg.mbh, 0);
            u.assign(size_t(cs) * 8 * cfg.mbh, 0);
            v.assign(size_t(cs) * 8 * cfg.mbh, 0);
        }
        Picture pic{y.data(), u.data(), v.data()};
        motion(pic);
        for (int r = 0; r < 16; ++r) {
            std::memcpy(py + 16 * r, y.data() + int64_t(16 * mb_y + r) * ls + 16 * mb_x, 16);
        }
        for (int r = 0; r < 8; ++r) {
            std::memcpy(pu + 8 * r, u.data() + int64_t(8 * mb_y + r) * cs + 8 * mb_x, 8);
            std::memcpy(pv + 8 * r, v.data() + int64_t(8 * mb_y + r) * cs + 8 * mb_x, 8);
        }
    }
    std::vector<uint8_t> scratch[3];

    int run(const int32_t* modes, const int32_t* qs, const int32_t* mvs_in, int ac_mode,
            int resync_every) {
        for (mb_y = 0; mb_y < cfg.mbh; ++mb_y) {
            for (mb_x = 0; mb_x < cfg.mbw; ++mb_x) {
                const int k = mb_y * cfg.mbw + mb_x;
                if (resync_every > 0 && k && k % resync_every == 0) {
                    w.stuffing();
                    w.put(prefix_length, 0);
                    w.put(1, 1);
                    w.put(mb_num_bits, k);
                    w.put(5, qscale);
                    w.put(1, 0);                                // no header extension
                    start_packet();
                    ++stats[8];
                }
                if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = false;
                const int mode = modes ? modes[k] : (cfg.coding_type ? kModeInter : kModeIntra);
                const int r = encode_mb(mode, qs ? qs[k] : qscale,
                                        mvs_in ? mvs_in + 8 * k : nullptr, ac_mode);
                if (r < 0) return r;
                finish_mb();
            }
        }
        w.stuffing();
        return kOk;
    }
};

bool valid(const Config& c) {
    return c.mbw > 0 && c.mbh > 0 && c.width > 0 && c.height > 0 && c.width <= 16 * c.mbw &&
           c.height <= 16 * c.mbh && c.qscale >= 1 && c.qscale <= 31 &&
           (c.coding_type == 0 || (c.coding_type == 1 && c.fcode >= 1 && c.fcode <= 7)) &&
           c.time_increment_bits >= 1 && c.time_increment_bits <= 16;
}

Config make_config(const int32_t* p) {
    Config c;
    c.mbw = p[0];
    c.mbh = p[1];
    c.width = p[2];
    c.height = p[3];
    c.coding_type = p[4];
    c.qscale = p[5];
    c.fcode = p[6];
    c.rounding = p[7];
    c.intra_dc_threshold = p[8];
    c.time_increment_bits = p[9];
    return c;
}

}  // namespace

// Decode one VOP's macroblocks.
//
// data, size: the sample; bit_pos: the first bit after the VOP header.
// params: mbw, mbh, width, height, coding type (0 I, 1 P), vop_quant,
//   vop_fcode_forward, vop_rounding_type, the intra DC VLC threshold, the
//   VOL's time increment bits.
// ref: the previous picture's Y, U, V at the coded size (P-VOPs only).
// out: this picture's Y, U, V at the coded size.
// error_pos: the bit position where decoding stopped.
// Returns 0, or a negative status (see Status above).
extern "C" int hive_mpeg4_decode_vop(const uint8_t* data, int64_t size, int64_t bit_pos,
                                     const int32_t* params, const uint8_t* const* ref,
                                     uint8_t* const* out, int64_t* error_pos) {
    const Config c = make_config(params);
    if (!valid(c) || (c.coding_type && !ref)) return kErrArguments;
    if (size < 0 || bit_pos < 0 || bit_pos > 8 * size) return kErrArguments;
    std::vector<uint8_t> buf(size + kPadding, 0);
    std::memcpy(buf.data(), data, size);
    Reader r{buf.data(), 8 * size, bit_pos};
    Decoder d(c, c.coding_type ? ref : nullptr, r);
    const int status = d.run({out[0], out[1], out[2]});
    *error_pos = r.pos;
    return status;
}

// Encode one VOP's macroblocks after `prefix` (its header, prefix_bits
// long) into `out`.
//
// params: as hive_mpeg4_decode_vop's. source: the picture's Y, U, V at the
// coded size. modes: per macroblock 0 inter, 1 inter 4MV, 2 intra, 3
// not_coded (null: all inter, or all intra in an I-VOP). qs: per
// macroblock the wanted quantiser, reached in DQUANT steps of at most 2
// (null: the VOP's). mvs: per macroblock four (x, y) half-pel vectors (1MV
// uses the first). ac_mode: 0 no AC prediction, 1 always, 2 where it
// saves bits. resync_every: a video packet every that many macroblocks (0:
// one packet).
// stats: nine counts of what was written (Encoder::stats).
// Returns the byte count, or a negative status; -capacity-1 when out is too
// small.
extern "C" int64_t hive_mpeg4_encode_vop(const int32_t* params, const uint8_t* const* source,
                                         const uint8_t* const* ref, const int32_t* modes,
                                         const int32_t* qs, const int32_t* mvs, int32_t ac_mode,
                                         int32_t resync_every, const uint8_t* prefix,
                                         int64_t prefix_bits, uint8_t* out, int64_t capacity,
                                         int64_t* stats) {
    const Config c = make_config(params);
    if (!valid(c) || (c.coding_type && !ref)) return kErrArguments;
    Encoder e(c, c.coding_type ? ref : nullptr, source);
    for (int64_t i = 0; i < prefix_bits; ++i) e.w.put(1, (prefix[i >> 3] >> (7 - (i & 7))) & 1);
    const int status = e.run(modes, qs, mvs, ac_mode, resync_every);
    if (status < 0) return status;
    std::memcpy(stats, e.stats, sizeof(e.stats));
    const int64_t n = static_cast<int64_t>(e.w.bytes.size());
    if (n > capacity) return -capacity - 1;
    std::memcpy(out, e.w.bytes.data(), n);
    return n;
}
