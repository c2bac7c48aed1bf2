// H.264 (ITU-T H.264 | ISO/IEC 14496-10) macroblock layer for CAVLC I and P
// slices of 8-bit 4:2:0 frame pictures, both ways: one slice's macroblocks
// decoded below its header as the standard specifies (and so as FFmpeg's
// h264 decoder, and cv2.VideoCapture, decode them), the picture's
// deblocking, and the matching encode, which writes the test fixtures.
//
// The Python side (hive_tpu_torch/video/h264.py) parses the parameter sets
// and slice headers, refuses what this file does not decode, keeps the
// decoded picture buffer (POC, reference marking, reference lists) and the
// per-picture macroblock state this file reads and writes (MbState, one a
// macroblock, zeroed for each picture). hive_h264_decode_slice takes the
// slice's RBSP from the bit after its header: mb_skip_run, mb_type,
// intra 4x4 / 16x16 / chroma prediction modes, I_PCM samples, P partitions
// and sub-partitions with ref_idx te(v) and motion vector differences,
// coded_block_pattern me(v), mb_qp_delta, and the CAVLC residual
// (coeff_token with nC from the neighbours, trailing ones, level_prefix /
// level_suffix with suffixLength adaptation, total_zeros, run_before); then
// reconstruction: intra prediction (8.3), median and directional motion
// vector prediction and P_Skip (8.4.1), quarter-sample luma and
// eighth-sample chroma interpolation with clamped reference coordinates
// (8.4.2.2), flat dequantisation, the 4x4 inverse transform and the luma /
// chroma DC transforms (8.5). hive_h264_deblock filters the whole picture
// once its slices are decoded (8.7): bS 0-4 (reference pictures compared by
// picture, not by index), alpha / beta / tc0 from the tables, each slice's
// disable_deblocking_filter_idc (0, 1, 2) and offsets, I_PCM at qP 0.
//
// The VLC tables are those of the standard (Tables 9-5, 9-7, 9-8, 9-9, 9-10
// and 9-4); every coeff_token, total_zeros and run_before codeword the
// encoder writes is counted, and the tests hold streams that use each of
// them to cv2 5.0.0's decode. This is host code, not a device kernel.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Tables.
// ---------------------------------------------------------------------------

// coeff_token (Table 9-5), indexed [TotalCoeff * 4 + TrailingOnes], for
// 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8 and 8 <= nC; length 0: no code.
const uint8_t kCoeffTokenLen[4][68] = {
    {1,  0,  0,  0,  6,  2,  0,  0,  8,  6,  3,  0,  9,  8,  7,  5,  10, 9,  8,  6,  11, 10, 9,
     7,  13, 11, 10, 8,  13, 13, 11, 9,  13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15,
     14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2,  0,  0,  0,  6,  2,  0,  0,  6,  5,  3,  0,  7,  6,  6,  4,  8,  6,  6,  4,  8,  7,  7,
     5,  9,  8,  8,  6,  11, 9,  9,  6,  11, 11, 11, 7,  12, 11, 11, 9,  12, 12, 12, 11, 12, 12,
     12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4,  0,  0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7,  5,  5,  4,  7,  5,  5,
     4,  7,  6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9,  8,  8,  7,  9,  9,
     8,  8,  9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6},
};
const uint8_t kCoeffTokenBits[4][68] = {
    {1,  0,  0, 0,  5,  1,  0, 0,  7,  4,  1, 0,  7, 6,  5,  3,  7,  6,  5, 3,  7,  6,  5,
     4,  15, 6, 5,  4,  11, 14, 5, 4,  8,  10, 13, 4, 15, 14, 9, 4,  11, 10, 13, 12, 15, 14,
     9,  12, 11, 10, 13, 8,  15, 1, 9,  12, 11, 14, 13, 8, 7,  10, 9,  12, 4, 6,  5,  8},
    {3,  0,  0,  0,  11, 2,  0,  0,  7,  7,  3,  0,  7,  10, 9, 5,  7,  6,  5,  4,  4,  6, 5,
     6,  7,  6,  5,  8,  15, 6,  5,  4,  11, 14, 13, 4,  15, 10, 9, 4,  11, 14, 13, 12, 8, 10,
     9,  8,  15, 14, 13, 12, 11, 10, 9,  12, 7,  11, 6,  8,  9,  8, 10, 1,  7,  6,  5,  4},
    {15, 0,  0,  0,  15, 14, 0,  0,  11, 15, 13, 0,  8,  12, 14, 12, 15, 10, 11, 11, 11, 8,  9,
     10, 9,  14, 13, 9,  8,  10, 9,  8,  15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14,
     9,  12, 8,  10, 13, 8,  13, 7,  9,  12, 9,  12, 11, 10, 5,  8,  7,  6,  1,  4,  3,  2},
    {3,  0,  0,  0,  0,  1,  0,  0,  4,  5,  6,  0,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18,
     19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
     42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63},
};
// coeff_token of chroma DC (nC == -1), [TotalCoeff * 4 + TrailingOnes].
const uint8_t kChromaDcTokenLen[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t kChromaDcTokenBits[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
// total_zeros of 4x4 blocks (Tables 9-7, 9-8), [TotalCoeff - 1][total_zeros].
const uint8_t kTotalZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},       {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},             {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},                   {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},                         {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},                               {4, 4, 2, 1, 3},
    {3, 3, 1, 2},                                     {2, 2, 1},
    {1, 1},
};
const uint8_t kTotalZerosBits[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},       {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},             {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},                   {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},                         {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},                               {0, 1, 1, 1, 1},
    {0, 1, 1, 1},                                     {0, 1, 1},
    {0, 1},
};
// total_zeros of chroma DC (Table 9-9 a), [TotalCoeff - 1][total_zeros].
const uint8_t kChromaDcZerosLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
const uint8_t kChromaDcZerosBits[3][4] = {{1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};
// run_before (Table 9-10), [min(zerosLeft, 7) - 1][run_before].
const uint8_t kRunLen[7][15] = {
    {1, 1}, {1, 2, 2}, {2, 2, 2, 2}, {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3}, {2, 3, 3, 3, 3, 3, 3},
    {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11},
};
const uint8_t kRunBits[7][15] = {
    {1, 0}, {1, 1, 0}, {3, 2, 1, 0}, {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0}, {3, 0, 1, 3, 2, 5, 4},
    {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1},
};
// coded_block_pattern's me(v) mapping (Table 9-4, ChromaArrayType 1).
const uint8_t kGolombToIntraCbp[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14,
                                       39, 43, 45, 46, 16, 3,  5,  10, 12, 19, 21, 26,
                                       28, 35, 37, 42, 44, 1,  2,  4,  8,  17, 18, 20,
                                       24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t kGolombToInterCbp[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15,
                                       47, 7,  11, 13, 14, 6,  9,  31, 35, 37, 42, 44,
                                       33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24,
                                       19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};
// Frame zig-zag scan: scan index -> raster position (row * 4 + column).
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// luma4x4BlkIdx -> its column and row in 4x4 blocks, and back.
const uint8_t kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
const uint8_t kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
const uint8_t kRasterToBlk[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};
// normAdjust4x4 (8.5.9): for qP % 6, positions (even, even), (odd, odd),
// and the others.
const int kDequant[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                            {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
// The encoder's forward quantisation multipliers, same classes.
const int kQuant[6][3] = {{13107, 5243, 8066}, {11916, 4660, 7490}, {10082, 4194, 6554},
                          {9362, 3647, 5825},  {8192, 3355, 5243},  {7282, 2893, 4559}};
// QPc of qPI (Table 8-15).
const uint8_t kChromaQp[52] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
                               13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
                               26, 27, 28, 29, 29, 30, 31, 32, 32, 33, 34, 34, 35,
                               35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
// Deblocking (Tables 8-16, 8-17): alpha', beta' and tc0 for bS 1-3.
const uint8_t kAlpha[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,
                            0,  0,  0,  4,  4,  5,  6,  7,  8,   9,   10,  12,  13,
                            15, 17, 20, 22, 25, 28, 32, 36, 40,  45,  50,  56,  63,
                            71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
const uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  2,  2,
                           2, 3, 3, 3, 3, 4, 4,  4,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                           11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
const uint8_t kTc0[52][3] = {
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 1},   {0, 0, 1},   {0, 0, 1},   {0, 0, 1},
    {0, 1, 1},   {0, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 1},   {1, 1, 2},
    {1, 1, 2},   {1, 1, 2},   {1, 1, 2},   {1, 2, 3},   {1, 2, 3},   {2, 2, 3},   {2, 2, 4},
    {2, 3, 4},   {2, 3, 4},   {3, 3, 5},   {3, 4, 6},   {3, 4, 6},   {4, 5, 7},   {4, 5, 8},
    {4, 6, 9},   {5, 7, 10},  {6, 8, 11},  {6, 8, 13},  {7, 10, 14}, {8, 11, 16}, {9, 12, 18},
    {10, 13, 20}, {11, 15, 23}, {13, 17, 25},
};

// The dequantisation class of raster position p of a 4x4 block.
inline int dq_class(int p) {
    const int r = p >> 2, c = p & 3;
    return (r & 1) == 0 && (c & 1) == 0 ? 0 : ((r & 1) && (c & 1) ? 1 : 2);
}
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int chroma_qp(int qp, int offset) { return kChromaQp[clip3(0, 51, qp + offset)]; }
inline int mid(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// A prefix code as a direct lookup on its longest length: entry = length
// << 10 | symbol, 0 where no codeword starts.
struct Vlc {
    int bits = 0;
    std::vector<uint16_t> entry;

    void add(int len, int code, int symbol) {
        const int span = 1 << (bits - len);
        for (int k = 0; k < span; ++k) entry[(code << (bits - len)) | k] = (len << 10) | symbol;
    }
};

Vlc make_vlc(const uint8_t* len, const uint8_t* code, int n, int symbol_step = 1) {
    Vlc v;
    for (int i = 0; i < n; ++i) v.bits = std::max<int>(v.bits, len[i]);
    v.entry.assign(size_t(1) << v.bits, 0);
    for (int i = 0; i < n; ++i)
        if (len[i]) v.add(len[i], code[i], i * symbol_step);
    return v;
}

struct Tables {
    Vlc token[5];        // nC classes 0-3, then chroma DC
    Vlc zeros[15];
    Vlc dc_zeros[3];
    Vlc run[7];
    uint8_t intra_cbp_code[48], inter_cbp_code[48];  // cbp -> codeNum

    Tables() {
        for (int t = 0; t < 4; ++t) token[t] = make_vlc(kCoeffTokenLen[t], kCoeffTokenBits[t], 68);
        token[4] = make_vlc(kChromaDcTokenLen, kChromaDcTokenBits, 20);
        for (int t = 0; t < 15; ++t)
            zeros[t] = make_vlc(kTotalZerosLen[t], kTotalZerosBits[t], 16 - t);
        for (int t = 0; t < 3; ++t)
            dc_zeros[t] = make_vlc(kChromaDcZerosLen[t], kChromaDcZerosBits[t], 4 - t);
        for (int t = 0; t < 7; ++t) run[t] = make_vlc(kRunLen[t], kRunBits[t], t < 6 ? t + 2 : 15);
        for (int k = 0; k < 48; ++k) {
            intra_cbp_code[kGolombToIntraCbp[k]] = static_cast<uint8_t>(k);
            inter_cbp_code[kGolombToInterCbp[k]] = static_cast<uint8_t>(k);
        }
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// ---------------------------------------------------------------------------
// Bits.
// ---------------------------------------------------------------------------

// How far a reader may go past a slice's end before overrun() says so.
const int kSlack = 48;
// Zero bytes after a slice: kSlack, then room for the most the decoder
// reads between two overrun() checks (one syntax element of at most 64
// bits, or one coefficient: a level of at most 60 bits and a run) and the
// 8-byte window.
const int kPadding = kSlack + 64;

struct Reader {
    const uint8_t* data;
    int64_t size_bits, pos, end_bits;

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
    // ue(v) of at most 32 leading zeros; -1 when longer (corrupt).
    int64_t ue() {
        const uint64_t w = window();
        const int zeros = w ? __builtin_clzll(w) : 64;
        if (zeros > 31) return -1;
        pos += zeros;
        const uint64_t bits = (uint64_t(get(zeros / 2 + 1)) << (zeros - zeros / 2)) |
                              get(zeros - zeros / 2);
        return static_cast<int64_t>(bits) - 1;
    }
    int64_t se() {
        const int64_t k = ue();
        if (k < 0) return INT64_MIN;
        return (k & 1) ? (k + 1) / 2 : -(k / 2);
    }
    int vlc(const Vlc& t) {
        const uint16_t e = t.entry[show(t.bits)];
        if (!e) return -1;
        pos += e >> 10;
        return e & 1023;
    }
    bool more_rbsp() const { return pos < end_bits; }
    bool overrun() const { return pos > size_bits + 8 * kSlack; }
};

struct Writer {
    std::vector<uint8_t> bytes;
    uint64_t acc = 0;
    int count = 0;
    int64_t bits = 0;

    void put(int n, uint32_t v) {
        if (!n) return;
        if (n > 24) {
            put(n - 16, v >> 16);
            put(16, v & 0xFFFF);
            return;
        }
        acc = (acc << n) | (v & ((uint64_t(1) << n) - 1));
        count += n;
        bits += n;
        while (count >= 8) {
            count -= 8;
            bytes.push_back(static_cast<uint8_t>(acc >> count));
        }
        acc &= (uint64_t(1) << count) - 1;
    }
    void ue(uint32_t v) {
        const uint64_t code = uint64_t(v) + 1;
        const int len = 63 - __builtin_clzll(code);
        put(len, 0);
        put(len + 1, static_cast<uint32_t>(code));
    }
    void se(int v) { ue(v > 0 ? 2 * v - 1 : -2 * v); }
    // rbsp_slice_trailing_bits: the stop bit, then zeros to the boundary.
    void trailing() {
        put(1, 1);
        if (count) put(8 - count, 0);
    }
};

// ---------------------------------------------------------------------------
// Per-picture state.
// ---------------------------------------------------------------------------

enum Kind : int8_t { kI4x4 = 0, kI16x16 = 1, kIPCM = 2, kInter = 3, kSkip = 4 };

// One macroblock of the picture being decoded, kept by the caller between
// the slices of the picture (zeroed for each picture) for the neighbours'
// lookups and the deblocking.
struct MbState {
    int32_t slice;          // slice number (1 up); 0 while not decoded
    int32_t ref_pic[16];    // the referenced picture's id per 4x4 block (raster), -1 intra
    int16_t mv[16][2];      // quarter-sample motion vectors per 4x4 block
    int8_t kind;
    int8_t qp;              // QP_Y
    int8_t lf_qp[3];        // qP of the deblocking for Y, Cb, Cr (0 and QPc(0) for I_PCM)
    int8_t lf_idc, lf_alpha, lf_beta;  // the slice's deblocking controls, offsets doubled
    int8_t ref_idx[16];
    int8_t i4mode[16];      // Intra4x4PredMode per 4x4 block (raster), -1 otherwise
    uint8_t nnz[24];        // TotalCoeff per luma 4x4 block (raster), Cb, Cr 4x4 blocks
};

enum Status {
    kOk = 0,
    kErrArguments = -1,
    kErrOverrun = -2,
    kErrMbType = -3,
    kErrCbp = -4,
    kErrQpDelta = -5,
    kErrCoeffToken = -6,
    kErrTotalZeros = -7,
    kErrRunBefore = -8,
    kErrLevel = -9,
    kErrIntraMode = -10,
    kErrRefIdx = -11,
    kErrSubMbType = -12,
    kErrSliceEnd = -13,
    kErrOverlap = -14,
    kErrGolomb = -15,
    kErrMissing = -16,
};

// The slice's parameters (params[] of the entry points).
struct Params {
    int mbw, mbh, slice, first_mb, slice_type, qp, num_ref, cqp_offset[2], constrained_intra;
    int lf_idc, lf_alpha, lf_beta, mb_count;
};

Params make_params(const int32_t* p) {
    Params c;
    c.mbw = p[0];
    c.mbh = p[1];
    c.slice = p[2];
    c.first_mb = p[3];
    c.slice_type = p[4];
    c.qp = p[5];
    c.num_ref = p[6];
    c.cqp_offset[0] = p[7];
    c.cqp_offset[1] = p[8];
    c.constrained_intra = p[9];
    c.lf_idc = p[10];
    c.lf_alpha = p[11];
    c.lf_beta = p[12];
    c.mb_count = p[13];
    return c;
}

bool valid(const Params& c) {
    return c.mbw > 0 && c.mbh > 0 && c.mbw <= 1024 && c.mbh <= 1024 && c.slice > 0 &&
           c.first_mb >= 0 && c.first_mb < c.mbw * c.mbh &&
           (c.slice_type == 0 || c.slice_type == 2) &&
           c.qp >= 0 && c.qp <= 51 && c.num_ref >= (c.slice_type == 0 ? 1 : 0) && c.num_ref <= 32 &&
           std::abs(c.cqp_offset[0]) <= 12 && std::abs(c.cqp_offset[1]) <= 12 && c.lf_idc >= 0 &&
           c.lf_idc <= 2 && std::abs(c.lf_alpha) <= 12 && std::abs(c.lf_beta) <= 12;
}

// A neighbour's motion: ref -2 not available, -1 intra (or not predicted).
struct Motion {
    int ref, x, y;
};

// What the decoder and the encoder share: the picture, its state, the
// neighbours, prediction and reconstruction.
struct Codec {
    Params c;
    const uint8_t* const* refs;  // 3 planes per reference index
    const int32_t* ref_ids;
    uint8_t* pic[3];
    int ys, cs;                  // luma and chroma strides (the coded width)
    MbState* st;
    int mbx = 0, mby = 0, addr = 0;
    MbState* cur = nullptr;
    uint16_t done = 0;           // the current macroblock's 4x4 blocks with motion
    bool avail_a = false, avail_b = false, avail_c = false, avail_d = false;  // for intra

    Codec(const Params& p, const uint8_t* const* r, const int32_t* ids, uint8_t* const* out,
          MbState* s)
        : c(p), refs(r), ref_ids(ids), st(s) {
        for (int k = 0; k < 3; ++k) pic[k] = out[k];
        ys = 16 * c.mbw;
        cs = 8 * c.mbw;
    }

    void start_mb(int a) {
        addr = a;
        mbx = a % c.mbw;
        mby = a / c.mbw;
        cur = &st[a];
        std::memset(cur, 0, sizeof(MbState));
        cur->slice = c.slice;
        cur->lf_idc = static_cast<int8_t>(c.lf_idc);
        cur->lf_alpha = static_cast<int8_t>(c.lf_alpha);
        cur->lf_beta = static_cast<int8_t>(c.lf_beta);
        std::memset(cur->i4mode, -1, 16);
        done = 0;
        auto usable = [&](int x, int y) {
            int lx = 0, ly = 0;
            const MbState* m = neighbour(x, y, &lx, &ly);
            return m && (!c.constrained_intra || m->kind <= kIPCM);
        };
        avail_a = usable(-1, 0);
        avail_b = usable(0, -1);
        avail_c = usable(16, -1);
        avail_d = usable(-1, -1);
    }

    // The macroblock holding luma position (x, y) relative to the current
    // macroblock, when it is available (inside the picture, in this slice);
    // (*lx, *ly) the position inside it. Right of the macroblock in its own
    // rows, and below it, nothing is available.
    MbState* neighbour(int x, int y, int* lx, int* ly) const {
        if (y >= 16 || (x >= 16 && y >= 0)) return nullptr;
        const int dx = x < 0 ? -1 : (x >= 16 ? 1 : 0), dy = y < 0 ? -1 : 0;
        *lx = x - 16 * dx;
        *ly = y - 16 * dy;
        if (!dx && !dy) return cur;
        const int mx = mbx + dx, my = mby + dy;
        if (mx < 0 || mx >= c.mbw || my < 0) return nullptr;
        MbState* m = &st[my * c.mbw + mx];
        return m->slice == c.slice ? m : nullptr;
    }

    // nC of luma 4x4 block (bx, by) (9.2.1).
    int luma_nc(int bx, int by) const {
        int ax = 0, ay = 0, bx2 = 0, by2 = 0;
        const MbState* a = neighbour(4 * bx - 1, 4 * by, &ax, &ay);
        const MbState* b = neighbour(4 * bx, 4 * by - 1, &bx2, &by2);
        const int na = a ? a->nnz[(ay >> 2) * 4 + (ax >> 2)] : 0;
        const int nb = b ? b->nnz[(by2 >> 2) * 4 + (bx2 >> 2)] : 0;
        return a && b ? (na + nb + 1) >> 1 : (a ? na : (b ? nb : 0));
    }
    // nC of chroma AC block (bx, by) of component k.
    int chroma_nc(int k, int bx, int by) const {
        int ax = 0, ay = 0, bx2 = 0, by2 = 0;
        const MbState* a = neighbour(8 * bx - 1, 8 * by, &ax, &ay);
        const MbState* b = neighbour(8 * bx, 8 * by - 1, &bx2, &by2);
        const int na = a ? a->nnz[16 + 4 * k + (ay >> 3) * 2 + (ax >> 3)] : 0;
        const int nb = b ? b->nnz[16 + 4 * k + (by2 >> 3) * 2 + (bx2 >> 3)] : 0;
        return a && b ? (na + nb + 1) >> 1 : (a ? na : (b ? nb : 0));
    }

    // predIntra4x4PredMode of 4x4 block (bx, by) (8.3.1.1).
    int pred_i4mode(int bx, int by) const {
        int ax = 0, ay = 0, bx2 = 0, by2 = 0;
        const MbState* a = neighbour(4 * bx - 1, 4 * by, &ax, &ay);
        const MbState* b = neighbour(4 * bx, 4 * by - 1, &bx2, &by2);
        auto inter = [&](const MbState* m) { return c.constrained_intra && m->kind > kIPCM; };
        if (!a || !b || inter(a) || inter(b)) return 2;
        const int ma = a->kind == kI4x4 ? a->i4mode[(ay >> 2) * 4 + (ax >> 2)] : 2;
        const int mb = b->kind == kI4x4 ? b->i4mode[(by2 >> 2) * 4 + (bx2 >> 2)] : 2;
        return std::min(ma, mb);
    }

    // Intra sample availability of 4x4 block (bx, by): left, top, top-right, top-left.
    void i4_avail(int bx, int by, bool* l, bool* t, bool* tr, bool* tl) const {
        *l = bx > 0 || avail_a;
        *t = by > 0 || avail_b;
        *tl = bx > 0 ? (by > 0 || avail_b) : (by > 0 ? avail_a : avail_d);
        if (by == 0)
            *tr = bx < 3 ? avail_b : avail_c;
        else
            *tr = bx < 3 && kRasterToBlk[(by - 1) * 4 + bx + 1] < kRasterToBlk[by * 4 + bx];
    }

    // -- motion vector prediction (8.4.1) --------------------------------------
    Motion motion_at(int x, int y) const {
        int lx = 0, ly = 0;
        const MbState* m = neighbour(x, y, &lx, &ly);
        const int b = (ly >> 2) * 4 + (lx >> 2);
        if (!m || (m == cur && !(done >> b & 1))) return {-2, 0, 0};
        if (m->kind <= kIPCM) return {-1, 0, 0};
        return {m->ref_idx[b], m->mv[b][0], m->mv[b][1]};
    }

    // mvpLX of the partition at (x, y), w x h luma samples, with ref_idx ref.
    void pred_mv(int x, int y, int w, int h, int ref, int* mx, int* my) const {
        const Motion a = motion_at(x - 1, y), b = motion_at(x, y - 1);
        Motion cc = motion_at(x + w, y - 1);
        if (cc.ref == -2) cc = motion_at(x - 1, y - 1);
        if (w == 16 && h == 8) {
            if (y == 0 && b.ref == ref) return void((*mx = b.x, *my = b.y));
            if (y == 8 && a.ref == ref) return void((*mx = a.x, *my = a.y));
        } else if (w == 8 && h == 16) {
            if (x == 0 && a.ref == ref) return void((*mx = a.x, *my = a.y));
            if (x == 8 && cc.ref == ref) return void((*mx = cc.x, *my = cc.y));
        }
        if (b.ref == -2 && cc.ref == -2 && a.ref != -2) return void((*mx = a.x, *my = a.y));
        const int matches = (a.ref == ref) + (b.ref == ref) + (cc.ref == ref);
        if (matches == 1) {
            const Motion& m = a.ref == ref ? a : (b.ref == ref ? b : cc);
            *mx = m.x;
            *my = m.y;
            return;
        }
        *mx = mid(a.x, b.x, cc.x);
        *my = mid(a.y, b.y, cc.y);
    }

    // P_Skip's motion vector (8.4.1.1).
    void skip_mv(int* mx, int* my) const {
        const Motion a = motion_at(-1, 0), b = motion_at(0, -1);
        if (a.ref == -2 || b.ref == -2 || (a.ref == 0 && !a.x && !a.y) ||
            (b.ref == 0 && !b.x && !b.y)) {
            *mx = *my = 0;
            return;
        }
        pred_mv(0, 0, 16, 16, 0, mx, my);
    }

    void set_motion(int x, int y, int w, int h, int ref, int mx, int my) {
        for (int by = y >> 2; by < (y + h) >> 2; ++by)
            for (int bx = x >> 2; bx < (x + w) >> 2; ++bx) {
                const int b = by * 4 + bx;
                cur->ref_idx[b] = static_cast<int8_t>(ref);
                cur->ref_pic[b] = ref_ids[ref];
                cur->mv[b][0] = static_cast<int16_t>(mx);
                cur->mv[b][1] = static_cast<int16_t>(my);
                done |= uint16_t(1) << b;
            }
    }

    // -- inter prediction (8.4.2.2) ----------------------------------------------
    // The partition at (x, y), w x h luma samples of the macroblock, from
    // reference `ref` moved by (mx, my) quarter samples, into the picture.
    void predict_inter(int x, int y, int w, int h, int ref, int mx, int my) {
        const int W = 16 * c.mbw, H = 16 * c.mbh;
        const int px = 16 * mbx + x, py = 16 * mby + y;
        luma_mc(pic[0] + py * ys + px, refs[3 * ref], W, H, px + (mx >> 2), py + (my >> 2), mx & 3,
                my & 3, w, h);
        for (int k = 1; k < 3; ++k)
            chroma_mc(pic[k] + (py / 2) * cs + px / 2, refs[3 * ref + k], W / 2, H / 2,
                      px / 2 + (mx >> 3), py / 2 + (my >> 3), mx & 7, my & 7, w / 2, h / 2);
    }

    void luma_mc(uint8_t* dst, const uint8_t* ref, int W, int H, int x, int y, int fx, int fy,
                 int w, int h) const {
        uint8_t win[21][21];
        for (int r = 0; r < h + 5; ++r) {
            const uint8_t* row = ref + clip3(0, H - 1, y - 2 + r) * W;
            for (int k = 0; k < w + 5; ++k) win[r][k] = row[clip3(0, W - 1, x - 2 + k)];
        }
        if (!fx && !fy) {
            for (int r = 0; r < h; ++r)
                for (int k = 0; k < w; ++k) dst[r * ys + k] = win[r + 2][k + 2];
            return;
        }
        auto tap = [](int a, int b, int cc, int d, int e, int f) {
            return a - 5 * b + 20 * cc + 20 * d - 5 * e + f;
        };
        // b1 for every window row, h for the block's rows and one more column.
        int b1[21][16], hh[16][17], bb[17][16], jj[16][16];
        for (int r = 0; r < h + 5; ++r)
            for (int k = 0; k < w; ++k)
                b1[r][k] = tap(win[r][k], win[r][k + 1], win[r][k + 2], win[r][k + 3],
                               win[r][k + 4], win[r][k + 5]);
        for (int r = 0; r < h + 1; ++r)
            for (int k = 0; k < w; ++k) bb[r][k] = clip1((b1[r + 2][k] + 16) >> 5);
        for (int r = 0; r < h; ++r)
            for (int k = 0; k < w + 1; ++k)
                hh[r][k] = clip1((tap(win[r][k + 2], win[r + 1][k + 2], win[r + 2][k + 2],
                                      win[r + 3][k + 2], win[r + 4][k + 2], win[r + 5][k + 2]) +
                                  16) >> 5);
        if (fx == 2 || fy == 2)
            for (int r = 0; r < h; ++r)
                for (int k = 0; k < w; ++k)
                    jj[r][k] = clip1((tap(b1[r][k], b1[r + 1][k], b1[r + 2][k], b1[r + 3][k],
                                          b1[r + 4][k], b1[r + 5][k]) + 512) >> 10);
        for (int r = 0; r < h; ++r)
            for (int k = 0; k < w; ++k) {
                const int G = win[r + 2][k + 2], Hs = win[r + 2][k + 3], M = win[r + 3][k + 2];
                const int b = bb[r][k], hv = hh[r][k], s = bb[r + 1][k], m = hh[r][k + 1];
                int v;
                switch (fy * 4 + fx) {
                    case 1: v = (G + b + 1) >> 1; break;                // a
                    case 2: v = b; break;                               // b
                    case 3: v = (Hs + b + 1) >> 1; break;               // c
                    case 4: v = (G + hv + 1) >> 1; break;               // d
                    case 5: v = (b + hv + 1) >> 1; break;               // e
                    case 6: v = (b + jj[r][k] + 1) >> 1; break;         // f
                    case 7: v = (b + m + 1) >> 1; break;                // g
                    case 8: v = hv; break;                              // h
                    case 9: v = (hv + jj[r][k] + 1) >> 1; break;        // i
                    case 10: v = jj[r][k]; break;                       // j
                    case 11: v = (jj[r][k] + m + 1) >> 1; break;        // k
                    case 12: v = (M + hv + 1) >> 1; break;              // n
                    case 13: v = (hv + s + 1) >> 1; break;              // p
                    case 14: v = (jj[r][k] + s + 1) >> 1; break;        // q
                    default: v = (m + s + 1) >> 1; break;               // r
                }
                dst[r * ys + k] = static_cast<uint8_t>(v);
            }
    }

    void chroma_mc(uint8_t* dst, const uint8_t* ref, int W, int H, int x, int y, int fx, int fy,
                   int w, int h) const {
        for (int r = 0; r < h; ++r) {
            const uint8_t* r0 = ref + clip3(0, H - 1, y + r) * W;
            const uint8_t* r1 = ref + clip3(0, H - 1, y + r + 1) * W;
            for (int k = 0; k < w; ++k) {
                const int x0 = clip3(0, W - 1, x + k), x1 = clip3(0, W - 1, x + k + 1);
                dst[r * cs + k] = static_cast<uint8_t>(
                    ((8 - fx) * (8 - fy) * r0[x0] + fx * (8 - fy) * r0[x1] +
                     (8 - fx) * fy * r1[x0] + fx * fy * r1[x1] + 32) >> 6);
            }
        }
    }

    // -- intra prediction (8.3) --------------------------------------------------
    // Whether 4x4 mode `mode` may be used with these neighbours.
    static bool i4_mode_ok(int mode, bool l, bool t, bool tl) {
        switch (mode) {
            case 0: case 3: case 7: return t;
            case 1: case 8: return l;
            case 2: return true;
            default: return l && t && tl;
        }
    }
    static bool i16_mode_ok(int mode, bool l, bool t, bool tl) {  // also chroma, renumbered
        switch (mode) {
            case 0: return t;
            case 1: return l;
            case 2: return true;
            default: return l && t && tl;
        }
    }

    void pred4x4(int bx, int by, int mode) {
        bool l, t, tr, tl;
        i4_avail(bx, by, &l, &t, &tr, &tl);
        uint8_t* p = pic[0] + (16 * mby + 4 * by) * ys + 16 * mbx + 4 * bx;
        int E[13];  // E[4 + k]: k -1 the corner, 0..7 the top row, -2 - j left row j
        int* e = E + 5;
        int T[8] = {0}, L[4] = {0};
        if (t) {
            for (int i = 0; i < 4; ++i) T[i] = p[-ys + i];
            for (int i = 4; i < 8; ++i) T[i] = tr ? p[-ys + i] : T[3];
        }
        if (l)
            for (int j = 0; j < 4; ++j) L[j] = p[j * ys - 1];
        const int Q = tl ? p[-ys - 1] : 0;
        for (int i = 0; i < 8; ++i) e[i] = T[i];
        e[-1] = Q;
        for (int j = 0; j < 4; ++j) e[-2 - j] = L[j];
        for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) {
                int v;
                switch (mode) {
                    case 0: v = T[x]; break;
                    case 1: v = L[y]; break;
                    case 2:
                        if (t && l)
                            v = (T[0] + T[1] + T[2] + T[3] + L[0] + L[1] + L[2] + L[3] + 4) >> 3;
                        else if (l)
                            v = (L[0] + L[1] + L[2] + L[3] + 2) >> 2;
                        else if (t)
                            v = (T[0] + T[1] + T[2] + T[3] + 2) >> 2;
                        else
                            v = 128;
                        break;
                    case 3:
                        v = x == 3 && y == 3
                                ? (T[6] + 3 * T[7] + 2) >> 2
                                : (T[x + y] + 2 * T[x + y + 1] + T[x + y + 2] + 2) >> 2;
                        break;
                    case 4: {
                        const int k = x - y - 1;
                        v = (e[k - 1] + 2 * e[k] + e[k + 1] + 2) >> 2;
                        break;
                    }
                    case 5: {
                        const int z = 2 * x - y;
                        const int k = x - (y >> 1);
                        if (z >= 0 && !(z & 1))
                            v = (e[k - 1] + e[k] + 1) >> 1;
                        else if (z > 0)
                            v = (e[k - 2] + 2 * e[k - 1] + e[k] + 2) >> 2;
                        else if (z == -1)
                            v = (e[-2] + 2 * e[-1] + e[0] + 2) >> 2;
                        else
                            v = (e[-1 - y] + 2 * e[-y] + e[1 - y] + 2) >> 2;
                        break;
                    }
                    case 6: {
                        const int z = 2 * y - x;
                        const int k = -1 - y + (x >> 1);  // e[k] = L[y - (x >> 1) - 1]
                        if (z >= 0 && !(z & 1))
                            v = (e[k] + e[k - 1] + 1) >> 1;
                        else if (z > 0)
                            v = (e[k + 1] + 2 * e[k] + e[k - 1] + 2) >> 2;
                        else if (z == -1)
                            v = (e[-2] + 2 * e[-1] + e[0] + 2) >> 2;
                        else
                            v = (e[x - 1] + 2 * e[x - 2] + e[x - 3] + 2) >> 2;
                        break;
                    }
                    case 7: {
                        const int k = x + (y >> 1);
                        v = (y & 1) ? (T[k] + 2 * T[k + 1] + T[k + 2] + 2) >> 2
                                    : (T[k] + T[k + 1] + 1) >> 1;
                        break;
                    }
                    default: {
                        const int z = x + 2 * y, k = y + (x >> 1);
                        if (z > 5)
                            v = L[3];
                        else if (z == 5)
                            v = (L[2] + 3 * L[3] + 2) >> 2;
                        else if (z & 1)
                            v = (L[k] + 2 * L[k + 1] + L[k + 2] + 2) >> 2;
                        else
                            v = (L[k] + L[k + 1] + 1) >> 1;
                        break;
                    }
                }
                p[y * ys + x] = static_cast<uint8_t>(v);
            }
    }

    void pred16x16(int mode) {
        uint8_t* p = pic[0] + 16 * mby * ys + 16 * mbx;
        const bool l = avail_a, t = avail_b;
        int T[16] = {0}, L[16] = {0};
        if (t)
            for (int i = 0; i < 16; ++i) T[i] = p[-ys + i];
        if (l)
            for (int j = 0; j < 16; ++j) L[j] = p[j * ys - 1];
        int dc = 128;
        if (mode == 2) {
            int s = 0;
            for (int i = 0; i < 16; ++i) s += (t ? T[i] : 0) + (l ? L[i] : 0);
            dc = t && l ? (s + 16) >> 5 : (t || l ? (s + 8) >> 4 : 128);
        }
        int a = 0, b = 0, cc = 0;
        if (mode == 3) {
            const int Q = p[-ys - 1];
            int Hs = 0, V = 0;
            for (int i = 0; i < 8; ++i) {
                Hs += (i + 1) * (T[8 + i] - (i < 7 ? T[6 - i] : Q));
                V += (i + 1) * (L[8 + i] - (i < 7 ? L[6 - i] : Q));
            }
            a = 16 * (L[15] + T[15]);
            b = (5 * Hs + 32) >> 6;
            cc = (5 * V + 32) >> 6;
        }
        for (int y = 0; y < 16; ++y)
            for (int x = 0; x < 16; ++x)
                p[y * ys + x] = mode == 0 ? T[x] : mode == 1 ? L[y] : mode == 2 ? dc
                                : clip1((a + b * (x - 7) + cc * (y - 7) + 16) >> 5);
    }

    // Chroma modes: 0 DC, 1 horizontal, 2 vertical, 3 plane.
    void pred_chroma(int mode) {
        const bool l = avail_a, t = avail_b;
        for (int k = 1; k < 3; ++k) {
            uint8_t* p = pic[k] + 8 * mby * cs + 8 * mbx;
            int T[8] = {0}, L[8] = {0};
            if (t)
                for (int i = 0; i < 8; ++i) T[i] = p[-cs + i];
            if (l)
                for (int j = 0; j < 8; ++j) L[j] = p[j * cs - 1];
            if (mode == 0) {
                for (int blk = 0; blk < 4; ++blk) {
                    const int xo = 4 * (blk & 1), yo = 4 * (blk >> 1);
                    int st_ = 0, sl = 0;
                    for (int i = 0; i < 4; ++i) {
                        st_ += T[xo + i];
                        sl += L[yo + i];
                    }
                    int v = 128;
                    if ((xo == 0 && yo == 0) || (xo && yo)) {
                        v = t && l ? (st_ + sl + 4) >> 3
                                   : l ? (sl + 2) >> 2 : t ? (st_ + 2) >> 2 : 128;
                    } else if (xo) {
                        v = t ? (st_ + 2) >> 2 : l ? (sl + 2) >> 2 : 128;
                    } else {
                        v = l ? (sl + 2) >> 2 : t ? (st_ + 2) >> 2 : 128;
                    }
                    for (int y = 0; y < 4; ++y)
                        for (int x = 0; x < 4; ++x)
                            p[(yo + y) * cs + xo + x] = static_cast<uint8_t>(v);
                }
                continue;
            }
            int a = 0, b = 0, cc = 0;
            if (mode == 3) {
                const int Q = p[-cs - 1];
                int Hs = 0, V = 0;
                for (int i = 0; i < 4; ++i) {
                    Hs += (i + 1) * (T[4 + i] - (i < 3 ? T[2 - i] : Q));
                    V += (i + 1) * (L[4 + i] - (i < 3 ? L[2 - i] : Q));
                }
                a = 16 * (L[7] + T[7]);
                b = (34 * Hs + 32) >> 6;
                cc = (34 * V + 32) >> 6;
            }
            for (int y = 0; y < 8; ++y)
                for (int x = 0; x < 8; ++x)
                    p[y * cs + x] = mode == 1 ? L[y] : mode == 2 ? T[x]
                                    : clip1((a + b * (x - 3) + cc * (y - 3) + 16) >> 5);
        }
    }

    // -- residual (8.5) ------------------------------------------------------------
    // coef: raster levels of one 4x4 block; dc: the already scaled DC, or
    // none (INT32_MIN: the block's own). Adds the block's residual to dst.
    static void idct_add(uint8_t* dst, int stride, const int32_t* coef, int qp, int32_t dc) {
        int d[16];
        const int shift = qp / 6, m = qp % 6;
        for (int p = 0; p < 16; ++p) d[p] = (coef[p] * kDequant[m][dq_class(p)]) << shift;
        if (dc != INT32_MIN) d[0] = dc;
        int t[16];
        for (int i = 0; i < 4; ++i) {
            const int* r = d + 4 * i;
            const int e = r[0] + r[2], f = r[0] - r[2];
            const int g = (r[1] >> 1) - r[3], h = r[1] + (r[3] >> 1);
            t[4 * i + 0] = e + h;
            t[4 * i + 1] = f + g;
            t[4 * i + 2] = f - g;
            t[4 * i + 3] = e - h;
        }
        for (int j = 0; j < 4; ++j) {
            const int e = t[j] + t[8 + j], f = t[j] - t[8 + j];
            const int g = (t[4 + j] >> 1) - t[12 + j], h = t[4 + j] + (t[12 + j] >> 1);
            const int r[4] = {e + h, f + g, f - g, e - h};
            for (int i = 0; i < 4; ++i)
                dst[i * stride + j] = clip1(dst[i * stride + j] + ((r[i] + 32) >> 6));
        }
    }

    // Luma DC of Intra16x16 (8.5.10): levels c (raster) -> scaled dcY (raster).
    static void luma_dc(const int32_t* c, int qp, int32_t* out) {
        int f[16], t[16];
        for (int i = 0; i < 4; ++i) {
            const int* r = c + 4 * i;
            t[4 * i + 0] = r[0] + r[1] + r[2] + r[3];
            t[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
            t[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
            t[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
        }
        for (int j = 0; j < 4; ++j) {
            const int a = t[j], b = t[4 + j], cc = t[8 + j], d = t[12 + j];
            f[j] = a + b + cc + d;
            f[4 + j] = a + b - cc - d;
            f[8 + j] = a - b - cc + d;
            f[12 + j] = a - b + cc - d;
        }
        const int scale = 16 * kDequant[qp % 6][0];
        for (int p = 0; p < 16; ++p)
            out[p] = qp >= 36 ? (f[p] * scale) << (qp / 6 - 6)
                              : (f[p] * scale + (1 << (5 - qp / 6))) >> (6 - qp / 6);
    }

    // Chroma DC (8.5.11): levels c[4] -> scaled dcC[4].
    static void chroma_dc(const int32_t* c, int qp, int32_t* out) {
        const int f[4] = {c[0] + c[1] + c[2] + c[3], c[0] - c[1] + c[2] - c[3],
                          c[0] + c[1] - c[2] - c[3], c[0] - c[1] - c[2] + c[3]};
        const int scale = 16 * kDequant[qp % 6][0];
        for (int p = 0; p < 4; ++p) out[p] = ((f[p] * scale) << (qp / 6)) >> 5;
    }

    // The macroblock's coefficients as parsed or chosen.
    struct Residual {
        int32_t luma[16][16];     // raster block, raster position
        int32_t luma_dc[16];      // Intra16x16 DC levels, raster
        int32_t chroma_dc[2][4];
        int32_t chroma_ac[2][4][16];
        void clear() { std::memset(this, 0, sizeof(*this)); }
    };

    void add_chroma_residual(const Residual& res, int cbp_chroma) {
        if (!cbp_chroma) return;
        for (int k = 0; k < 2; ++k) {
            const int qpc = chroma_qp(cur->qp, c.cqp_offset[k]);
            int32_t dc[4];
            chroma_dc(res.chroma_dc[k], qpc, dc);
            uint8_t* p = pic[1 + k] + 8 * mby * cs + 8 * mbx;
            for (int b = 0; b < 4; ++b)
                idct_add(p + 4 * (b >> 1) * cs + 4 * (b & 1), cs, res.chroma_ac[k][b], qpc, dc[b]);
        }
    }

    void set_lf_qp(int qp_y) {
        cur->lf_qp[0] = static_cast<int8_t>(qp_y);
        cur->lf_qp[1] = static_cast<int8_t>(chroma_qp(qp_y, c.cqp_offset[0]));
        cur->lf_qp[2] = static_cast<int8_t>(chroma_qp(qp_y, c.cqp_offset[1]));
    }

    void set_intra_motion() {
        for (int b = 0; b < 16; ++b) {
            cur->ref_idx[b] = -1;
            cur->ref_pic[b] = -1;
        }
    }
};

// The partitions of P macroblock types 0-2 as (x, y, w, h).
const int kParts[3][2][4] = {{{0, 0, 16, 16}, {0, 0, 0, 0}},
                             {{0, 0, 16, 8}, {0, 8, 16, 8}},
                             {{0, 0, 8, 16}, {8, 0, 8, 16}}};
const int kSubParts[4] = {1, 2, 2, 4};
// Sub-partition k of sub_mb_type t inside its 8x8: (x, y, w, h).
void sub_part(int t, int k, int* x, int* y, int* w, int* h) {
    *w = t == 0 || t == 1 ? 8 : 4;
    *h = t == 0 || t == 2 ? 8 : 4;
    *x = t == 2 || t == 3 ? 4 * (k & 1) : 0;
    *y = t == 1 ? 4 * k : (t == 3 ? 4 * (k >> 1) : 0);
}

// ---------------------------------------------------------------------------
// The decoder.
// ---------------------------------------------------------------------------

struct Decoder : Codec {
    Reader& r;
    int qp_prev;
    Residual res;

    Decoder(const Params& p, const uint8_t* const* refs_, const int32_t* ids, uint8_t* const* out,
            MbState* s, Reader& rd)
        : Codec(p, refs_, ids, out, s), r(rd), qp_prev(p.qp) {}

    int run() {
        const int total = c.mbw * c.mbh;
        int a = c.first_mb;
        bool more = true;
        while (more) {
            if (c.slice_type == 0) {
                const int64_t skip = r.ue();
                if (skip < 0) return kErrGolomb;
                if (r.overrun()) return kErrOverrun;
                if (skip > total - a) return kErrSliceEnd;
                for (int64_t k = 0; k < skip; ++k) {
                    const int status = decode_skip(a++);
                    if (status) return status;
                }
                if (skip > 0 && !r.more_rbsp()) break;
            }
            if (a >= total) return kErrSliceEnd;
            const int status = decode_mb(a++);
            if (status) return status;
            if (r.overrun()) return kErrOverrun;
            more = r.more_rbsp();
        }
        return kOk;
    }

    int begin(int a) {
        if (st[a].slice) return kErrOverlap;
        start_mb(a);
        return kOk;
    }

    int decode_skip(int a) {
        const int status = begin(a);
        if (status) return status;
        if (!refs[0]) return kErrMissing;
        int mx, my;
        skip_mv(&mx, &my);
        set_motion(0, 0, 16, 16, 0, mx, my);
        cur->kind = kSkip;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(qp_prev);
        predict_inter(0, 0, 16, 16, 0, mx, my);
        return kOk;
    }

    int ref_idx() {
        if (c.num_ref == 2) return !r.get1();
        const int64_t v = r.ue();
        return v < 0 || v >= c.num_ref ? -1 : static_cast<int>(v);
    }

    int decode_mb(int a) {
        int status = begin(a);
        if (status) return status;
        int64_t mb_type = r.ue();
        if (mb_type < 0) return kErrGolomb;
        bool intra = true;
        if (c.slice_type == 0) {
            if (mb_type < 5)
                intra = false;
            else
                mb_type -= 5;
        }
        if (intra && mb_type > 25) return kErrMbType;
        res.clear();
        int cbp = 0;
        if (intra && mb_type == 25) return decode_pcm();
        if (intra) {
            cur->kind = mb_type == 0 ? kI4x4 : kI16x16;
            set_intra_motion();
            if (cur->kind == kI4x4) {
                for (int k = 0; k < 16; ++k) {
                    const int bx = kBlkX[k], by = kBlkY[k];
                    const int pred = pred_i4mode(bx, by);
                    int mode = pred;
                    if (!r.get1()) {
                        const int rem = static_cast<int>(r.get(3));
                        mode = rem < pred ? rem : rem + 1;
                    }
                    cur->i4mode[by * 4 + bx] = static_cast<int8_t>(mode);
                }
            }
            const int64_t chroma_mode = r.ue();
            if (chroma_mode < 0 || chroma_mode > 3) return kErrIntraMode;
            if (r.overrun()) return kErrOverrun;
            int i16mode = 0;
            if (cur->kind == kI16x16) {
                const int t = static_cast<int>(mb_type) - 1;
                i16mode = t % 4;
                cbp = ((t / 4) % 3) << 4 | (t >= 12 ? 15 : 0);
            } else {
                const int64_t code = r.ue();
                if (code < 0 || code > 47) return kErrCbp;
                cbp = kGolombToIntraCbp[code];
            }
            status = read_qp_and_residual(cbp);
            if (status) return status;
            // Reconstruction.
            static const int kChromaToI16[4] = {2, 1, 0, 3};
            if (!i16_mode_ok(kChromaToI16[chroma_mode], avail_a, avail_b, avail_d))
                return kErrIntraMode;
            if (cur->kind == kI4x4) {
                for (int k = 0; k < 16; ++k) {
                    const int bx = kBlkX[k], by = kBlkY[k], b = by * 4 + bx;
                    bool l, t, tr, tl;
                    i4_avail(bx, by, &l, &t, &tr, &tl);
                    if (!i4_mode_ok(cur->i4mode[b], l, t, tl)) return kErrIntraMode;
                    pred4x4(bx, by, cur->i4mode[b]);
                    if (cbp >> (b >> 3 << 1 | (b & 3) >> 1) & 1)
                        idct_add(pic[0] + (16 * mby + 4 * by) * ys + 16 * mbx + 4 * bx, ys,
                                 res.luma[b], cur->qp, INT32_MIN);
                }
            } else {
                if (!i16_mode_ok(i16mode, avail_a, avail_b, avail_d)) return kErrIntraMode;
                pred16x16(i16mode);
                int32_t dc[16];
                luma_dc(res.luma_dc, cur->qp, dc);
                for (int b = 0; b < 16; ++b)
                    idct_add(pic[0] + (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3), ys,
                             res.luma[b], cur->qp, dc[b]);
            }
            pred_chroma(static_cast<int>(chroma_mode));
            add_chroma_residual(res, cbp >> 4);
            return kOk;
        }

        // Inter.
        cur->kind = kInter;
        if (mb_type < 3) {
            const int n = mb_type == 0 ? 1 : 2;
            int refs_[2] = {0, 0};
            for (int k = 0; k < n; ++k)
                if (c.num_ref > 1 && (refs_[k] = ref_idx()) < 0) return kErrRefIdx;
            for (int k = 0; k < n; ++k) {
                const int* p = kParts[mb_type][k];
                const int64_t dx = r.se(), dy = r.se();
                if (dx == INT64_MIN || dy == INT64_MIN) return kErrGolomb;
                if (r.overrun()) return kErrOverrun;
                if (!refs[3 * refs_[k]]) return kErrMissing;
                int mx, my;
                pred_mv(p[0], p[1], p[2], p[3], refs_[k], &mx, &my);
                mx = static_cast<int16_t>(mx + dx);
                my = static_cast<int16_t>(my + dy);
                set_motion(p[0], p[1], p[2], p[3], refs_[k], mx, my);
                predict_inter(p[0], p[1], p[2], p[3], refs_[k], mx, my);
            }
        } else {
            int sub[4], refs_[4] = {0, 0, 0, 0};
            for (int k = 0; k < 4; ++k) {
                const int64_t t = r.ue();
                if (t < 0 || t > 3) return kErrSubMbType;
                sub[k] = static_cast<int>(t);
            }
            if (mb_type == 3 && c.num_ref > 1)
                for (int k = 0; k < 4; ++k)
                    if ((refs_[k] = ref_idx()) < 0) return kErrRefIdx;
            for (int k = 0; k < 4; ++k) {
                if (!refs[3 * refs_[k]]) return kErrMissing;
                for (int j = 0; j < kSubParts[sub[k]]; ++j) {
                    int x, y, w, h;
                    sub_part(sub[k], j, &x, &y, &w, &h);
                    x += 8 * (k & 1);
                    y += 8 * (k >> 1);
                    const int64_t dx = r.se(), dy = r.se();
                    if (dx == INT64_MIN || dy == INT64_MIN) return kErrGolomb;
                    if (r.overrun()) return kErrOverrun;
                    int mx, my;
                    pred_mv(x, y, w, h, refs_[k], &mx, &my);
                    mx = static_cast<int16_t>(mx + dx);
                    my = static_cast<int16_t>(my + dy);
                    set_motion(x, y, w, h, refs_[k], mx, my);
                    predict_inter(x, y, w, h, refs_[k], mx, my);
                }
            }
        }
        const int64_t code = r.ue();
        if (code < 0 || code > 47) return kErrCbp;
        cbp = kGolombToInterCbp[code];
        status = read_qp_and_residual(cbp);
        if (status) return status;
        for (int b = 0; b < 16; ++b)
            if (cbp >> (b >> 3 << 1 | (b & 3) >> 1) & 1)
                idct_add(pic[0] + (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3), ys,
                         res.luma[b], cur->qp, INT32_MIN);
        add_chroma_residual(res, cbp >> 4);
        return kOk;
    }

    int decode_pcm() {
        r.pos = (r.pos + 7) & ~int64_t(7);
        if (r.pos + 8 * 384 > r.size_bits) return kErrOverrun;
        const uint8_t* s = r.data + (r.pos >> 3);
        for (int y = 0; y < 16; ++y)
            std::memcpy(pic[0] + (16 * mby + y) * ys + 16 * mbx, s + 16 * y, 16);
        for (int k = 0; k < 2; ++k)
            for (int y = 0; y < 8; ++y)
                std::memcpy(pic[1 + k] + (8 * mby + y) * cs + 8 * mbx, s + 256 + 64 * k + 8 * y, 8);
        r.pos += 8 * 384;
        cur->kind = kIPCM;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(0);
        set_intra_motion();
        std::memset(cur->nnz, 16, 24);
        return kOk;
    }

    int read_qp_and_residual(int cbp) {
        int qp = qp_prev;
        if (cbp || cur->kind == kI16x16) {
            const int64_t delta = r.se();
            if (delta == INT64_MIN) return kErrGolomb;
            if (delta < -26 || delta > 25) return kErrQpDelta;
            qp = (qp_prev + static_cast<int>(delta) + 52) % 52;
        }
        qp_prev = qp;
        cur->qp = static_cast<int8_t>(qp);
        set_lf_qp(qp);
        if (r.overrun()) return kErrOverrun;
        int32_t levels[16];
        int total;
        if (cur->kind == kI16x16) {
            int status = read_block(luma_nc(0, 0), 16, levels, &total);
            if (status) return status;
            for (int i = 0; i < 16; ++i) res.luma_dc[kZigzag[i]] = levels[i];
        }
        for (int k = 0; k < 16; ++k) {
            const int bx = kBlkX[k], by = kBlkY[k], b = by * 4 + bx;
            if (!(cbp >> (k >> 2) & 1)) {
                cur->nnz[b] = 0;
                continue;
            }
            if (cur->kind == kI16x16) {
                int status = read_block(luma_nc(bx, by), 15, levels, &total);
                if (status) return status;
                for (int i = 0; i < 15; ++i) res.luma[b][kZigzag[i + 1]] = levels[i];
            } else {
                int status = read_block(luma_nc(bx, by), 16, levels, &total);
                if (status) return status;
                for (int i = 0; i < 16; ++i) res.luma[b][kZigzag[i]] = levels[i];
            }
            cur->nnz[b] = static_cast<uint8_t>(total);
        }
        const int cbp_chroma = cbp >> 4;
        if (cbp_chroma)
            for (int k = 0; k < 2; ++k) {
                int status = read_block(-1, 4, levels, &total);
                if (status) return status;
                for (int i = 0; i < 4; ++i) res.chroma_dc[k][i] = levels[i];
            }
        if (cbp_chroma & 2)
            for (int k = 0; k < 2; ++k)
                for (int b = 0; b < 4; ++b) {
                    int status = read_block(chroma_nc(k, b & 1, b >> 1), 15, levels, &total);
                    if (status) return status;
                    for (int i = 0; i < 15; ++i) res.chroma_ac[k][b][kZigzag[i + 1]] = levels[i];
                    cur->nnz[16 + 4 * k + b] = static_cast<uint8_t>(total);
                }
        return kOk;
    }

    // residual_block_cavlc (7.3.5.3.2, 9.2): levels[0..max_coeff) in scan order.
    int read_block(int nc, int max_coeff, int32_t* levels, int* total_out) {
        const Tables& tb = tables();
        std::memset(levels, 0, sizeof(int32_t) * 16);
        const Vlc& tt = nc < 0 ? tb.token[4] : tb.token[nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3];
        const int token = r.vlc(tt);
        if (token < 0) return kErrCoeffToken;
        const int total = token >> 2, ones = token & 3;
        *total_out = total;
        if (total > max_coeff) return kErrCoeffToken;
        if (!total) return kOk;
        int vals[16];
        int suffix = total > 10 && ones < 3 ? 1 : 0;
        for (int i = 0; i < total; ++i) {
            if (r.overrun()) return kErrOverrun;
            if (i < ones) {
                vals[i] = r.get1() ? -1 : 1;
                continue;
            }
            int prefix = 0;
            while (!r.get1()) {
                if (++prefix > 28) return kErrLevel;
            }
            int code = std::min(15, prefix) << suffix;
            if (suffix > 0 || prefix >= 14) {
                const int size =
                    prefix == 14 && suffix == 0 ? 4 : (prefix >= 15 ? prefix - 3 : suffix);
                code += static_cast<int>(r.get(size));
            }
            if (prefix >= 15 && suffix == 0) code += 15;
            if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
            if (i == ones && ones < 3) code += 2;
            vals[i] = code & 1 ? (-code - 1) >> 1 : (code + 2) >> 1;
            if (!suffix) suffix = 1;
            if (std::abs(vals[i]) > (3 << (suffix - 1)) && suffix < 6) ++suffix;
        }
        int zeros = 0;
        if (total < max_coeff) {
            zeros = r.vlc(max_coeff == 4 ? tb.dc_zeros[total - 1] : tb.zeros[total - 1]);
            if (zeros < 0 || zeros > max_coeff - total) return kErrTotalZeros;
        }
        int runs[16];
        int left = zeros;
        for (int i = 0; i < total - 1; ++i) {
            runs[i] = 0;
            if (left > 0) {
                runs[i] = r.vlc(tb.run[std::min(left, 7) - 1]);
                if (runs[i] < 0 || runs[i] > left) return kErrRunBefore;
                left -= runs[i];
            }
        }
        runs[total - 1] = left;
        int pos = -1;
        for (int i = total - 1; i >= 0; --i) {
            pos += runs[i] + 1;
            levels[pos] = vals[i];
        }
        return kOk;
    }
};

// ---------------------------------------------------------------------------
// Deblocking (8.7).
// ---------------------------------------------------------------------------

int boundary_strength(const MbState& p, int pb, const MbState& q, int qb, bool mb_edge) {
    if (p.kind <= kIPCM || q.kind <= kIPCM) return mb_edge ? 4 : 3;
    if (p.nnz[pb] || q.nnz[qb]) return 2;
    if (p.ref_pic[pb] != q.ref_pic[qb]) return 1;
    if (std::abs(p.mv[pb][0] - q.mv[qb][0]) >= 4 || std::abs(p.mv[pb][1] - q.mv[qb][1]) >= 4)
        return 1;
    return 0;
}

// Filter `n` lines across an edge: q0 of line k at base + k * along, p0
// at q0 - step.
void filter_edge(uint8_t* base, int step, int along, int n, int bs, int qp_av, int off_a, int off_b,
                 bool chroma) {
    if (!bs) return;
    const int ia = clip3(0, 51, qp_av + off_a), ib = clip3(0, 51, qp_av + off_b);
    const int alpha = kAlpha[ia], beta = kBeta[ib];
    if (!alpha || !beta) return;
    const int tc0 = bs < 4 ? kTc0[ia][bs - 1] : 0;
    for (int k = 0; k < n; ++k) {
        uint8_t* q = base + k * along;
        const int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
        if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta))
            continue;
        if (chroma) {
            if (bs < 4) {
                const int tc = tc0 + 1;
                const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
                q[-step] = clip1(p0 + delta);
                q[0] = clip1(q0 - delta);
            } else {
                q[-step] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
                q[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
            }
            continue;
        }
        const int p2 = q[-3 * step], q2 = q[2 * step];
        const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
        if (bs < 4) {
            const int tc = tc0 + (ap < beta) + (aq < beta);
            const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
            q[-step] = clip1(p0 + delta);
            q[0] = clip1(q0 - delta);
            const int avg = (p0 + q0 + 1) >> 1;
            if (ap < beta)
                q[-2 * step] =
                    static_cast<uint8_t>(p1 + clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1));
            if (aq < beta)
                q[step] = static_cast<uint8_t>(q1 + clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1));
            continue;
        }
        const int p3 = q[-4 * step], q3 = q[3 * step];
        const bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
        if (ap < beta && strong) {
            q[-step] = static_cast<uint8_t>((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
            q[-2 * step] = static_cast<uint8_t>((p2 + p1 + p0 + q0 + 2) >> 2);
            q[-3 * step] = static_cast<uint8_t>((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        } else {
            q[-step] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
        }
        if (aq < beta && strong) {
            q[0] = static_cast<uint8_t>((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
            q[step] = static_cast<uint8_t>((p0 + q0 + q1 + q2 + 2) >> 2);
            q[2 * step] = static_cast<uint8_t>((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
        } else {
            q[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
        }
    }
}

void deblock_mb(const MbState* st, int mbw, int mx, int my, uint8_t* const* pic) {
    const MbState& q = st[my * mbw + mx];
    if (q.lf_idc == 1) return;
    const int ys = 16 * mbw, cs = 8 * mbw;
    const bool left = mx > 0 && (q.lf_idc == 0 || st[my * mbw + mx - 1].slice == q.slice);
    const bool top = my > 0 && (q.lf_idc == 0 || st[(my - 1) * mbw + mx].slice == q.slice);
    for (int dir = 0; dir < 2; ++dir) {         // vertical edges, then horizontal
        const bool outer = dir == 0 ? left : top;
        const MbState& p_mb = dir == 0 ? (mx > 0 ? st[my * mbw + mx - 1] : q)
                                       : (my > 0 ? st[(my - 1) * mbw + mx] : q);
        int bs[4][4];                            // [edge][block along the edge]
        for (int e = 0; e < 4; ++e)
            for (int k = 0; k < 4; ++k) {
                const int qb = dir == 0 ? k * 4 + e : e * 4 + k;
                if (e == 0) {
                    const int pb = dir == 0 ? k * 4 + 3 : 12 + k;
                    bs[e][k] = outer ? boundary_strength(p_mb, pb, q, qb, true) : 0;
                } else {
                    const int pb = dir == 0 ? qb - 1 : qb - 4;
                    bs[e][k] = boundary_strength(q, pb, q, qb, false);
                }
            }
        const int step_y = dir == 0 ? 1 : ys, along_y = dir == 0 ? ys : 1;
        uint8_t* y0 = pic[0] + 16 * my * ys + 16 * mx;
        for (int e = 0; e < 4; ++e) {
            if (e == 0 && !outer) continue;
            const MbState& p = e == 0 ? p_mb : q;
            const int qp_av = (p.lf_qp[0] + q.lf_qp[0] + 1) >> 1;
            for (int k = 0; k < 4; ++k) {
                uint8_t* base = dir == 0 ? y0 + 4 * k * ys + 4 * e : y0 + 4 * e * ys + 4 * k;
                filter_edge(base, step_y, along_y, 4, bs[e][k], qp_av, q.lf_alpha, q.lf_beta,
                            false);
            }
        }
        const int step_c = dir == 0 ? 1 : cs, along_c = dir == 0 ? cs : 1;
        for (int ch = 1; ch < 3; ++ch) {
            uint8_t* c0 = pic[ch] + 8 * my * cs + 8 * mx;
            for (int e = 0; e < 2; ++e) {
                if (e == 0 && !outer) continue;
                const MbState& p = e == 0 ? p_mb : q;
                const int qp_av = (p.lf_qp[ch] + q.lf_qp[ch] + 1) >> 1;
                for (int k = 0; k < 4; ++k) {
                    uint8_t* base = dir == 0 ? c0 + 2 * k * cs + 4 * e : c0 + 4 * e * cs + 2 * k;
                    filter_edge(base, step_c, along_c, 2, bs[2 * e][k], qp_av, q.lf_alpha,
                                q.lf_beta, true);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The encoder (the test fixtures).
// ---------------------------------------------------------------------------

// Plan record per macroblock (int32): kind (0 I4x4, 1 I16x16, 2 I_PCM, 3
// P16x16, 4 P16x8, 5 P8x16, 6 P8x8, 7 P8x8ref0, 8 P_Skip), the 16x16 mode,
// the chroma mode, QP, sub_mb_type[4], ref_idx[4] (per 8x8; partitions take
// their first 8x8's), the 4x4 modes [16] (raster), motion vectors [16][2]
// (raster 4x4 blocks; partitions take their first block's).
const int kPlanInts = 60;
// Kind 9 is I4x4 whose luma levels are given (levels[], 16 a 4x4 block in
// raster order, each block's in scan order) instead of quantised: the
// probes that read single VLC codewords back from another decoder.
enum PlanKind { kPlanI4 = 0, kPlanI16, kPlanPcm, kPlanP16, kPlanP16x8, kPlanP8x16, kPlanP8x8,
                kPlanP8x8Ref0, kPlanSkip, kPlanI4Levels };

// Counts the encoder returns, in this order (h264.py STAT_NAMES), then
// coverage: coeff_token (5 x 68), total_zeros (15 x 16 + 3 x 4), run_before (7 x 15).
enum Stat {
    kStatI4Mode = 0,           // 9
    kStatI16Mode = 9,          // 4
    kStatChromaMode = 13,      // 4
    kStatPcm = 17,
    kStatP16x16, kStatP16x8, kStatP8x16, kStatP8x8, kStatP8x8Ref0,
    kStatSub = 23,             // 4
    kStatSkip = 27,
    kStatSkipRuns,
    kStatIntraInP,
    kStatQpDelta,
    kStatMvOutside,
    kStatRefIdxNonzero,
    kStatLevelPrefix14,
    kStatLevelPrefix15,
    kStatSuffixLength6,
    kStatCbpChromaAc,
    kNumStats,
};
const int kCoverToken = kNumStats, kCoverZeros = kCoverToken + 5 * 68,
          kCoverDcZeros = kCoverZeros + 15 * 16, kCoverRun = kCoverDcZeros + 3 * 4,
          kStatsTotal = kCoverRun + 7 * 15;

struct Encoder : Codec {
    Writer w;
    const uint8_t* const* src;
    const int32_t* plan;
    const int32_t* forced;
    int64_t* stats;
    int qp_prev;
    Residual res;

    Encoder(const Params& p, const uint8_t* const* refs_, const int32_t* ids, uint8_t* const* out,
            MbState* s, const uint8_t* const* source, const int32_t* pl, const int32_t* lv,
            int64_t* st_)
        : Codec(p, refs_, ids, out, s), src(source), plan(pl), forced(lv), stats(st_),
          qp_prev(p.qp) {}

    int run() {
        int skip = 0;
        const int end = std::min(c.first_mb + c.mb_count, c.mbw * c.mbh);
        for (int a = c.first_mb; a < end; ++a) {
            const int32_t* pl = plan + int64_t(a) * kPlanInts;
            start_mb(a);
            if (c.slice_type == 0 && pl[0] == kPlanSkip) {
                encode_skip();
                ++skip;
                continue;
            }
            if (c.slice_type == 0) {
                w.ue(skip);
                if (skip) ++stats[kStatSkipRuns];
                skip = 0;
            }
            const int status = encode_mb(pl);
            if (status) return status;
        }
        if (skip) {
            w.ue(skip);
            ++stats[kStatSkipRuns];
        }
        w.trailing();
        return kOk;
    }

    void encode_skip() {
        int mx, my;
        skip_mv(&mx, &my);
        set_motion(0, 0, 16, 16, 0, mx, my);
        cur->kind = kSkip;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(qp_prev);
        predict_inter(0, 0, 16, 16, 0, mx, my);
        ++stats[kStatSkip];
        count_outside(0, 0, 16, 16, mx, my);
    }

    void count_outside(int x, int y, int w_, int h, int mx, int my) {
        const int px = 16 * mbx + x + (mx >> 2), py = 16 * mby + y + (my >> 2);
        if (px < 0 || py < 0 || px + w_ > 16 * c.mbw || py + h > 16 * c.mbh)
            ++stats[kStatMvOutside];
    }

    void te(int v) {
        if (c.num_ref == 2)
            w.put(1, !v);
        else
            w.ue(v);
    }

    int encode_mb(const int32_t* pl) {
        int kind = pl[0];
        const bool p_slice = c.slice_type == 0;
        if (kind == kPlanI4Levels && !forced) return kErrArguments;
        if (!p_slice && kind > kPlanPcm && kind != kPlanI4Levels) kind = kPlanI16;
        res.clear();
        const int target_qp = clip3(std::max(0, qp_prev - 26), std::min(51, qp_prev + 25), pl[3]);
        cur->qp = static_cast<int8_t>(target_qp);
        if (kind <= kPlanPcm || kind == kPlanI4Levels) {
            if (p_slice) ++stats[kStatIntraInP];
            if (kind == kPlanPcm) return encode_pcm();
            return encode_intra(kind, pl, target_qp);
        }
        return encode_inter(kind, pl, target_qp);
    }

    int encode_pcm() {
        w.ue(c.slice_type == 0 ? 30 : 25);
        if (w.count) w.put(8 - w.count, 0);
        for (int y = 0; y < 16; ++y) {
            const uint8_t* s = src[0] + (16 * mby + y) * ys + 16 * mbx;
            for (int x = 0; x < 16; ++x) w.put(8, s[x]);
            std::memcpy(pic[0] + (16 * mby + y) * ys + 16 * mbx, s, 16);
        }
        for (int k = 1; k < 3; ++k)
            for (int y = 0; y < 8; ++y) {
                const uint8_t* s = src[k] + (8 * mby + y) * cs + 8 * mbx;
                for (int x = 0; x < 8; ++x) w.put(8, s[x]);
                std::memcpy(pic[k] + (8 * mby + y) * cs + 8 * mbx, s, 8);
            }
        cur->kind = kIPCM;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(0);
        set_intra_motion();
        std::memset(cur->nnz, 16, 24);
        ++stats[kStatPcm];
        return kOk;
    }

    // -- transform and quantisation --------------------------------------------------
    static void fdct(const int* x, int* out) {  // raster in, raster out
        int t[16];
        for (int i = 0; i < 4; ++i) {
            const int* r = x + 4 * i;
            const int a = r[0] + r[3], b = r[1] + r[2], cc = r[1] - r[2], d = r[0] - r[3];
            t[4 * i + 0] = a + b;
            t[4 * i + 1] = 2 * d + cc;
            t[4 * i + 2] = a - b;
            t[4 * i + 3] = d - 2 * cc;
        }
        for (int j = 0; j < 4; ++j) {
            const int a = t[j] + t[12 + j], b = t[4 + j] + t[8 + j], cc = t[4 + j] - t[8 + j],
                      d = t[j] - t[12 + j];
            out[j] = a + b;
            out[4 + j] = 2 * d + cc;
            out[8 + j] = a - b;
            out[12 + j] = d - 2 * cc;
        }
    }
    // A level bounded so that its code needs at most level_prefix 15 and its
    // dequantised value (times `gain`) stays in 16 bits.
    static int bound(int level, int qp, int cls, int gain) {
        const int scale = (kDequant[qp % 6][cls] << (qp / 6)) * gain;
        const int lim = std::min(2047, std::max(1, 32000 / std::max(1, scale)));
        return clip3(-lim, lim, level);
    }
    static int quant(int v, int qp, int cls, bool intra, int extra_shift = 0) {
        const int qbits = 15 + qp / 6 + extra_shift;
        const int64_t f = (int64_t(1) << qbits) / (intra ? 3 : 6);
        const int64_t mag = (int64_t(std::abs(v)) * kQuant[qp % 6][cls] + f) >> qbits;
        return v < 0 ? -static_cast<int>(mag) : static_cast<int>(mag);
    }
    // Residual of the 4x4 block at dst (prediction) against s; levels raster.
    void block_levels(const uint8_t* s, int ss, const uint8_t* p, int ps, int qp, bool intra,
                      int32_t* levels, int* dc_coef) {
        int diff[16], coef[16];
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) diff[4 * i + j] = s[i * ss + j] - p[i * ps + j];
        fdct(diff, coef);
        for (int k = 0; k < 16; ++k)
            levels[k] = bound(quant(coef[k], qp, dq_class(k), intra), qp, dq_class(k), 1);
        if (dc_coef) {
            *dc_coef = coef[0];
            levels[0] = 0;
        }
    }

    static bool any(const int32_t* v, int n) {
        for (int k = 0; k < n; ++k)
            if (v[k]) return true;
        return false;
    }

    // Chroma residual of the prediction in the picture: levels into res; cbp chroma.
    int chroma_levels(int qp, bool intra) {
        int cbp = 0;
        for (int k = 0; k < 2; ++k) {
            const int qpc = chroma_qp(qp, c.cqp_offset[k]);
            int dcs[4];
            for (int b = 0; b < 4; ++b) {
                const int off = (8 * mby + 4 * (b >> 1)) * cs + 8 * mbx + 4 * (b & 1);
                block_levels(src[1 + k] + off, cs, pic[1 + k] + off, cs, qpc, intra,
                             res.chroma_ac[k][b], &dcs[b]);
            }
            const int f[4] = {dcs[0] + dcs[1] + dcs[2] + dcs[3], dcs[0] - dcs[1] + dcs[2] - dcs[3],
                              dcs[0] + dcs[1] - dcs[2] - dcs[3], dcs[0] - dcs[1] - dcs[2] + dcs[3]};
            for (int b = 0; b < 4; ++b)
                res.chroma_dc[k][b] = bound(quant(f[b], qpc, 0, intra, 1), qpc, 0, 2);
            if (any(res.chroma_dc[k], 4)) cbp = std::max(cbp, 1);
            for (int b = 0; b < 4; ++b)
                if (any(res.chroma_ac[k][b], 16)) cbp = 2;
        }
        if (cbp < 2)
            for (int k = 0; k < 2; ++k) std::memset(res.chroma_ac[k], 0, sizeof(res.chroma_ac[k]));
        return cbp;
    }

    void write_qp(int qp) {
        int delta = qp - qp_prev;
        if (delta > 25) delta -= 52;
        if (delta < -26) delta += 52;
        w.se(delta);
        if (delta) ++stats[kStatQpDelta];
        qp_prev = qp;
    }

    int encode_intra(int kind, const int32_t* pl, int qp) {
        static const int kChromaToI16[4] = {2, 1, 0, 3};
        cur->kind = kind == kPlanI16 ? kI16x16 : kI4x4;
        set_intra_motion();
        int chroma_mode = pl[2] & 3;
        if (!i16_mode_ok(kChromaToI16[chroma_mode], avail_a, avail_b, avail_d)) chroma_mode = 0;
        int cbp_luma = 0, i16mode = 0;
        int32_t dc_levels[16] = {0};
        if (cur->kind == kI4x4) {
            for (int k = 0; k < 16; ++k) {
                const int bx = kBlkX[k], by = kBlkY[k], b = by * 4 + bx;
                bool l, t, tr, tl;
                i4_avail(bx, by, &l, &t, &tr, &tl);
                int mode = pl[12 + b] % 9;
                if (!i4_mode_ok(mode, l, t, tl)) mode = 2;
                cur->i4mode[b] = static_cast<int8_t>(mode);
                pred4x4(bx, by, mode);
                const int off = (16 * mby + 4 * by) * ys + 16 * mbx + 4 * bx;
                if (kind == kPlanI4Levels) {
                    const int32_t* given = forced + (int64_t(addr) * 16 + b) * 16;
                    for (int i = 0; i < 16; ++i)
                        res.luma[b][kZigzag[i]] = clip3(-2047, 2047, given[i]);
                } else {
                    block_levels(src[0] + off, ys, pic[0] + off, ys, qp, true, res.luma[b],
                                 nullptr);
                }
                if (any(res.luma[b], 16)) {
                    cbp_luma |= 1 << (k >> 2);
                    idct_add(pic[0] + off, ys, res.luma[b], qp, INT32_MIN);
                }
            }
        } else {
            i16mode = pl[1] & 3;
            if (!i16_mode_ok(i16mode, avail_a, avail_b, avail_d)) i16mode = 2;
            pred16x16(i16mode);
            int dcs[16];
            for (int b = 0; b < 16; ++b) {
                const int off = (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3);
                block_levels(src[0] + off, ys, pic[0] + off, ys, qp, true, res.luma[b], &dcs[b]);
                if (any(res.luma[b], 16)) cbp_luma = 15;
            }
            int t[16], f[16];
            for (int i = 0; i < 4; ++i) {
                const int* r = dcs + 4 * i;
                t[4 * i + 0] = r[0] + r[1] + r[2] + r[3];
                t[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
                t[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
                t[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
            }
            for (int j = 0; j < 4; ++j) {
                const int a = t[j], b = t[4 + j], cc = t[8 + j], d = t[12 + j];
                f[j] = (a + b + cc + d) / 2;
                f[4 + j] = (a + b - cc - d) / 2;
                f[8 + j] = (a - b - cc + d) / 2;
                f[12 + j] = (a - b + cc - d) / 2;
            }
            for (int p = 0; p < 16; ++p)
                dc_levels[p] = bound(quant(f[p], qp, 0, true, 1), qp, 0, 4);
            std::memcpy(res.luma_dc, dc_levels, sizeof(dc_levels));
            if (!cbp_luma)
                for (int b = 0; b < 16; ++b) std::memset(res.luma[b], 0, sizeof(res.luma[b]));
        }
        pred_chroma(chroma_mode);
        const int cbp_chroma = chroma_levels(qp, true);
        const int cbp = cbp_chroma << 4 | cbp_luma;
        // Syntax.
        const int offset = c.slice_type == 0 ? 5 : 0;
        if (cur->kind == kI4x4) {
            w.ue(offset);
            for (int k = 0; k < 16; ++k) {
                const int b = kBlkY[k] * 4 + kBlkX[k];
                const int pred = pred_i4mode(kBlkX[k], kBlkY[k]), mode = cur->i4mode[b];
                if (mode == pred) {
                    w.put(1, 1);
                } else {
                    w.put(1, 0);
                    w.put(3, mode < pred ? mode : mode - 1);
                }
                ++stats[kStatI4Mode + mode];
            }
        } else {
            w.ue(offset + 1 + i16mode + 4 * cbp_chroma + (cbp_luma ? 12 : 0));
            ++stats[kStatI16Mode + i16mode];
        }
        w.ue(chroma_mode);
        ++stats[kStatChromaMode + chroma_mode];
        if (cur->kind == kI4x4) w.ue(tables().intra_cbp_code[cbp]);
        const bool coded = cbp || cur->kind == kI16x16;
        if (coded) write_qp(qp);
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(qp_prev);
        write_residual(cbp);
        // Reconstruct what is not yet: the Intra16x16 luma and the chroma.
        if (cur->kind == kI16x16) {
            int32_t dc[16];
            luma_dc(res.luma_dc, qp, dc);
            for (int b = 0; b < 16; ++b)
                idct_add(pic[0] + (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3), ys,
                         res.luma[b], qp, dc[b]);
        }
        add_chroma_residual(res, cbp_chroma);
        if (cbp_chroma == 2) ++stats[kStatCbpChromaAc];
        return kOk;
    }

    int encode_inter(int kind, const int32_t* pl, int qp) {
        cur->kind = kInter;
        const int32_t* mvs = pl + 28;
        auto ref_of = [&](int k8) {
            return kind == kPlanP8x8Ref0 ? 0 : std::min(pl[8 + k8], c.num_ref - 1);
        };
        struct Part { int x, y, w, h, ref, mx, my, dx, dy; };
        Part parts[16];
        int n = 0, sub[4] = {0, 0, 0, 0};
        if (kind <= kPlanP8x16) {
            const int t = kind - kPlanP16;
            for (int k = 0; k < (t ? 2 : 1); ++k) {
                const int* p = kParts[t][k];
                const int b = (p[1] >> 2) * 4 + (p[0] >> 2);
                parts[n++] = {p[0], p[1], p[2], p[3], ref_of((p[1] >> 3) * 2 + (p[0] >> 3)),
                              mvs[2 * b], mvs[2 * b + 1], 0, 0};
            }
            ++stats[kStatP16x16 + t];
        } else {
            for (int k = 0; k < 4; ++k) {
                sub[k] = pl[4 + k] & 3;
                ++stats[kStatSub + sub[k]];
                for (int j = 0; j < kSubParts[sub[k]]; ++j) {
                    int x, y, ww, h;
                    sub_part(sub[k], j, &x, &y, &ww, &h);
                    x += 8 * (k & 1);
                    y += 8 * (k >> 1);
                    const int b = (y >> 2) * 4 + (x >> 2);
                    parts[n++] = {x, y, ww, h, ref_of(k), mvs[2 * b], mvs[2 * b + 1], 0, 0};
                }
            }
            ++stats[kind == kPlanP8x8 ? kStatP8x8 : kStatP8x8Ref0];
        }
        for (int k = 0; k < n; ++k) {
            Part& p = parts[k];
            p.mx = clip3(-8192, 8191, p.mx);
            p.my = clip3(-2048, 2047, p.my);
            int px, py;
            pred_mv(p.x, p.y, p.w, p.h, p.ref, &px, &py);
            p.dx = p.mx - px;
            p.dy = p.my - py;
            set_motion(p.x, p.y, p.w, p.h, p.ref, p.mx, p.my);
            predict_inter(p.x, p.y, p.w, p.h, p.ref, p.mx, p.my);
            count_outside(p.x, p.y, p.w, p.h, p.mx, p.my);
            if (p.ref) ++stats[kStatRefIdxNonzero];
        }
        int cbp_luma = 0;
        for (int k = 0; k < 16; ++k) {
            const int b = kBlkY[k] * 4 + kBlkX[k];
            const int off = (16 * mby + 4 * kBlkY[k]) * ys + 16 * mbx + 4 * kBlkX[k];
            block_levels(src[0] + off, ys, pic[0] + off, ys, qp, false, res.luma[b], nullptr);
            if (any(res.luma[b], 16)) cbp_luma |= 1 << (k >> 2);
        }
        for (int k = 0; k < 16; ++k)
            if (!(cbp_luma >> (k >> 2) & 1)) std::memset(res.luma[kBlkY[k] * 4 + kBlkX[k]], 0, 64);
        const int cbp_chroma = chroma_levels(qp, false);
        const int cbp = cbp_chroma << 4 | cbp_luma;
        // Syntax.
        if (kind <= kPlanP8x16) {
            w.ue(kind - kPlanP16);
            if (c.num_ref > 1)
                for (int k = 0; k < n; ++k) te(parts[k].ref);
            for (int k = 0; k < n; ++k) {
                w.se(parts[k].dx);
                w.se(parts[k].dy);
            }
        } else {
            w.ue(kind == kPlanP8x8 ? 3 : 4);
            for (int k = 0; k < 4; ++k) w.ue(sub[k]);
            if (kind == kPlanP8x8 && c.num_ref > 1)
                for (int k = 0; k < 4; ++k) te(ref_of(k));
            for (int k = 0; k < n; ++k) {
                w.se(parts[k].dx);
                w.se(parts[k].dy);
            }
        }
        w.ue(tables().inter_cbp_code[cbp]);
        if (cbp) write_qp(qp);
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(qp_prev);
        write_residual(cbp);
        for (int b = 0; b < 16; ++b)
            if (cbp >> (b >> 3 << 1 | (b & 3) >> 1) & 1)
                idct_add(pic[0] + (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3), ys,
                         res.luma[b], qp, INT32_MIN);
        add_chroma_residual(res, cbp_chroma);
        if (cbp_chroma == 2) ++stats[kStatCbpChromaAc];
        return kOk;
    }

    void write_residual(int cbp) {
        int32_t levels[16];
        if (cur->kind == kI16x16) {
            for (int i = 0; i < 16; ++i) levels[i] = res.luma_dc[kZigzag[i]];
            write_block(luma_nc(0, 0), 16, levels);
        }
        for (int k = 0; k < 16; ++k) {
            const int bx = kBlkX[k], by = kBlkY[k], b = by * 4 + bx;
            if (!(cbp >> (k >> 2) & 1)) {
                cur->nnz[b] = 0;
                continue;
            }
            int total;
            if (cur->kind == kI16x16) {
                for (int i = 0; i < 15; ++i) levels[i] = res.luma[b][kZigzag[i + 1]];
                total = write_block(luma_nc(bx, by), 15, levels);
            } else {
                for (int i = 0; i < 16; ++i) levels[i] = res.luma[b][kZigzag[i]];
                total = write_block(luma_nc(bx, by), 16, levels);
            }
            cur->nnz[b] = static_cast<uint8_t>(total);
        }
        if (cbp >> 4)
            for (int k = 0; k < 2; ++k) write_block(-1, 4, res.chroma_dc[k]);
        if (cbp >> 5)
            for (int k = 0; k < 2; ++k)
                for (int b = 0; b < 4; ++b) {
                    for (int i = 0; i < 15; ++i) levels[i] = res.chroma_ac[k][b][kZigzag[i + 1]];
                    cur->nnz[16 + 4 * k + b] =
                        static_cast<uint8_t>(write_block(chroma_nc(k, b & 1, b >> 1), 15, levels));
                }
    }

    // residual_block_cavlc, written; the TotalCoeff.
    int write_block(int nc, int max_coeff, const int32_t* levels) {
        int total = 0, last = -1;
        for (int i = 0; i < max_coeff; ++i)
            if (levels[i]) {
                ++total;
                last = i;
            }
        int vals[16], runs[16];
        int n = 0, run = 0;
        for (int i = last; i >= 0; --i) {
            if (levels[i]) {
                if (n) runs[n - 1] = run;
                vals[n++] = levels[i];
                run = 0;
            } else {
                ++run;
            }
        }
        if (n) runs[n - 1] = run;  // zeros before the lowest coefficient
        int ones = 0;
        while (ones < n && ones < 3 && std::abs(vals[ones]) == 1) ++ones;
        const int table = nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
        const int token = total * 4 + ones;
        if (table == 4)
            w.put(kChromaDcTokenLen[token], kChromaDcTokenBits[token]);
        else
            w.put(kCoeffTokenLen[table][token], kCoeffTokenBits[table][token]);
        ++stats[kCoverToken + table * 68 + token];
        if (!total) return 0;
        int suffix = total > 10 && ones < 3 ? 1 : 0;
        for (int i = 0; i < total; ++i) {
            if (i < ones) {
                w.put(1, vals[i] < 0);
                continue;
            }
            int code = vals[i] > 0 ? 2 * vals[i] - 2 : -2 * vals[i] - 1;
            if (i == ones && ones < 3) code -= 2;
            if (suffix == 0) {
                if (code < 14) {
                    w.put(code + 1, 1);
                } else if (code < 30) {
                    w.put(15, 1);
                    w.put(4, code - 14);
                    ++stats[kStatLevelPrefix14];
                } else {
                    w.put(16, 1);
                    w.put(12, code - 30);
                    ++stats[kStatLevelPrefix15];
                }
            } else if (code < (15 << suffix)) {
                w.put((code >> suffix) + 1, 1);
                w.put(suffix, code & ((1 << suffix) - 1));
            } else {
                w.put(16, 1);
                w.put(12, code - (15 << suffix));
                ++stats[kStatLevelPrefix15];
            }
            if (!suffix) suffix = 1;
            if (std::abs(vals[i]) > (3 << (suffix - 1)) && suffix < 6) {
                ++suffix;
                if (suffix == 6) ++stats[kStatSuffixLength6];
            }
        }
        int zeros = last + 1 - total;
        if (total < max_coeff) {
            if (max_coeff == 4) {
                w.put(kChromaDcZerosLen[total - 1][zeros], kChromaDcZerosBits[total - 1][zeros]);
                ++stats[kCoverDcZeros + (total - 1) * 4 + zeros];
            } else {
                w.put(kTotalZerosLen[total - 1][zeros], kTotalZerosBits[total - 1][zeros]);
                ++stats[kCoverZeros + (total - 1) * 16 + zeros];
            }
        }
        for (int i = 0; i < total - 1 && zeros > 0; ++i) {
            const int t = std::min(zeros, 7) - 1;
            w.put(kRunLen[t][runs[i]], kRunBits[t][runs[i]]);
            ++stats[kCoverRun + t * 15 + runs[i]];
            zeros -= runs[i];
        }
        return total;
    }
};

}  // namespace

// The size of one macroblock's state (MbState): the caller keeps
// width_in_mbs * height_in_mbs of them a picture, zeroed.
extern "C" int hive_h264_mb_state_bytes() { return static_cast<int>(sizeof(MbState)); }

// The counts hive_h264_encode_slice returns (named, then the coverage of
// the VLC tables).
extern "C" int hive_h264_stat_counts(int32_t* named) {
    *named = kNumStats;
    return kStatsTotal;
}

// Decode one slice's macroblocks.
//
// data, size: the slice NAL unit's RBSP (emulation prevention removed);
// bit_pos: the first bit after the slice header.
// params: width and height in macroblocks, the slice's number in the
//   picture (1 up), first_mb_in_slice, slice type (0 P, 2 I), SliceQP_Y,
//   num_ref_idx_l0_active, chroma_qp_index_offset for Cb and Cr,
//   constrained_intra_pred_flag, disable_deblocking_filter_idc,
//   FilterOffsetA, FilterOffsetB, (unused).
// refs: Y, U, V of each entry of RefPicList0 at the coded size (null: no
//   picture there); ref_ids: an id per entry naming its picture.
// out: the picture's Y, U, V at the coded size; state: its MbState array.
// error_pos: the bit where decoding stopped.
// Returns 0, or a negative status (Status above).
extern "C" int hive_h264_decode_slice(const uint8_t* data, int64_t size, int64_t bit_pos,
                                      const int32_t* params, const uint8_t* const* refs,
                                      const int32_t* ref_ids, uint8_t* const* out, uint8_t* state,
                                      int64_t* error_pos) {
    const Params c = make_params(params);
    *error_pos = bit_pos;
    if (!valid(c) || size < 0 || bit_pos < 0 || bit_pos > 8 * size) return kErrArguments;
    std::vector<uint8_t> buf(size + kPadding, 0);
    std::memcpy(buf.data(), data, size);
    int64_t end = 0;
    for (int64_t i = size - 1; i >= 0; --i)
        if (data[i]) {
            end = 8 * i + 7 - __builtin_ctz(data[i]);
            break;
        }
    Reader r{buf.data(), 8 * size, bit_pos, end};
    Decoder d(c, refs, ref_ids, out, reinterpret_cast<MbState*>(state), r);
    const int status = d.run();
    *error_pos = r.pos;
    return status;
}

// Deblock a decoded picture in place. params: width and height in
// macroblocks. Returns 0, or kErrSliceEnd when a macroblock was never decoded.
extern "C" int hive_h264_deblock(const int32_t* params, const uint8_t* state,
                                 uint8_t* const* planes) {
    const int mbw = params[0], mbh = params[1];
    const MbState* st = reinterpret_cast<const MbState*>(state);
    for (int k = 0; k < mbw * mbh; ++k)
        if (!st[k].slice) return kErrSliceEnd;
    for (int my = 0; my < mbh; ++my)
        for (int mx = 0; mx < mbw; ++mx) deblock_mb(st, mbw, mx, my, planes);
    return kOk;
}

// Encode params[13] macroblocks from first_mb_in_slice after `prefix` (the
// slice header, prefix_bits long) into `out`, with the slice's trailing bits.
//
// params: as hive_h264_decode_slice's, params[13] the macroblock count.
// source: the picture's Y, U, V at the coded size. refs, ref_ids: as the
// decoder's. recon: the picture as the decoder rebuilds it before
// deblocking; state: its MbState array. plan: kPlanInts int32 a macroblock
// of the picture (see kPlanInts).
// levels: null, or 256 int32 a macroblock for plan kind 9 (see kPlanI4Levels).
// stats: kStatsTotal counts, added to.
// Returns the byte count, or a negative status; -capacity-1 when out is too
// small.
extern "C" int64_t hive_h264_encode_slice(const int32_t* params, const uint8_t* const* source,
                                          const uint8_t* const* refs, const int32_t* ref_ids,
                                          uint8_t* const* recon, uint8_t* state,
                                          const int32_t* plan, const int32_t* levels,
                                          const uint8_t* prefix,
                                          int64_t prefix_bits, uint8_t* out, int64_t capacity,
                                          int64_t* stats) {
    const Params c = make_params(params);
    if (!valid(c) || c.mb_count < 1) return kErrArguments;
    if (c.slice_type == 0)
        for (int k = 0; k < c.num_ref; ++k)
            if (!refs[3 * k]) return kErrMissing;
    Encoder e(c, refs, ref_ids, recon, reinterpret_cast<MbState*>(state), source, plan, levels,
              stats);
    for (int64_t i = 0; i < prefix_bits; ++i) e.w.put(1, (prefix[i >> 3] >> (7 - (i & 7))) & 1);
    const int status = e.run();
    if (status < 0) return status;
    const int64_t n = static_cast<int64_t>(e.w.bytes.size());
    if (n > capacity) return -capacity - 1;
    std::memcpy(out, e.w.bytes.data(), n);
    return n;
}
