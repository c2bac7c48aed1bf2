// H.264 (ITU-T H.264 | ISO/IEC 14496-10) macroblock layer for I, P and B
// slices of 8-bit 4:2:0 frame pictures, CAVLC or CABAC, both ways: one
// slice's macroblocks decoded below its header as the standard specifies
// (and so as FFmpeg's h264 decoder, and cv2.VideoCapture, decode them), the
// picture's deblocking, and the matching encode, which writes the test
// fixtures.
//
// The Python side (hive_tpu_torch/video/h264.py) parses the parameter sets
// and slice headers (the scaling lists and the prediction weight tables
// resolved), refuses what this file does not decode, keeps the decoded
// picture buffer (POC, reference marking, reference lists 0 and 1) and the
// per-picture macroblock state this file reads and writes (MbState, one a
// macroblock, zeroed for each picture; a reference picture's is kept as
// the co-located picture's motion for B slices' direct prediction).
// hive_h264_decode_slice takes the slice's RBSP from the bit after its
// header: mb_skip_run or mb_skip_flag, mb_type, transform_size_8x8_flag,
// intra 4x4 / 8x8 / 16x16 / chroma prediction modes, I_PCM samples, P and
// B partitions and sub-partitions with ref_idx and motion vector
// differences of each list, coded_block_pattern, mb_qp_delta and the
// residual: CAVLC (coeff_token with nC from the neighbours, trailing ones,
// level_prefix / level_suffix with suffixLength adaptation, total_zeros,
// run_before; an 8x8 block as four interleaved 4x4 scans) or CABAC (9.3:
// the arithmetic decoding engine, each element's binarisation and
// ctxIdxInc, the significance map, coeff_abs_level_minus1 and the bypass
// bins, I_PCM's re-initialisation); then reconstruction: intra prediction
// (8.3, the 8x8 modes with their reference sample filter), median and
// directional motion vector prediction, P_Skip, and B_Skip / B_Direct's
// spatial and temporal direct prediction with and without
// direct_8x8_inference (8.4.1), quarter-sample luma and eighth-sample
// chroma interpolation with clamped reference coordinates (8.4.2.2), the
// default, explicit and implicit weighted sample prediction (8.4.2.3),
// dequantisation with the scaling matrices (LevelScale4x4 and
// LevelScale8x8), the 4x4 and 8x8 inverse transforms and the luma / chroma
// DC transforms (8.5). hive_h264_deblock filters the whole picture once its
// slices are decoded (8.7): bS 0-4 (reference pictures compared by picture,
// not by index, and a block's pair of lists against the other's either way
// round; an 8x8 transform block's coefficients count for its four 4x4
// blocks), alpha / beta / tc0 from the tables, each slice's
// disable_deblocking_filter_idc (0, 1, 2) and offsets, I_PCM at qP 0, and
// no internal 4-sample luma edges in a macroblock of 8x8 transforms.
//
// The VLC tables are those of the standard (Tables 9-5, 9-7, 9-8, 9-9, 9-10
// and 9-4), the CABAC and 8x8 tables those of h264_tables.h; every VLC
// codeword and every CABAC context the encoder writes is counted, and the
// tests hold streams that use each of them to cv2 5.0.0's decode. This is
// host code, not a device kernel.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cabac.h"
#include "h264_tables.h"

namespace {

using namespace h264;

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
// The class of raster position p of an 8x8 block in normAdjust8x8 (8.5.9).
inline int norm8x8_class(int p) {
    const int i = p >> 3, j = p & 7;
    if (i % 4 == 0 && j % 4 == 0) return 0;
    if (i % 2 == 1 && j % 2 == 1) return 1;
    if (i % 4 == 2 && j % 4 == 2) return 2;
    if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) return 3;
    if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) return 4;
    return 5;
}
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
// The luma 4x4 blocks (raster bits) of 8x8 block b8.
inline uint16_t mask8(int b8) { return static_cast<uint16_t>(0x33 << (8 * (b8 >> 1) + 2 * (b8 & 1))); }
// A scaled coefficient kept to 25 bits: a conforming stream's are 16 bits
// (8.5.12.1); a corrupt one's cannot overflow the transforms.
inline int scaled(int64_t v) { return static_cast<int>(std::max<int64_t>(-(1 << 24), std::min<int64_t>(1 << 24, v))); }
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
// lookups and the deblocking, and then as a co-located macroblock.
struct MbState {
    int32_t slice;          // slice number (1 up); 0 while not decoded
    int32_t ref_pic[2][16]; // the referenced picture's id per list and 4x4 block (raster), -1 none
    int16_t mv[2][16][2];   // quarter-sample motion vectors per list and 4x4 block (0: list unused)
    int8_t kind;
    int8_t qp;              // QP_Y
    int8_t lf_qp[3];        // qP of the deblocking for Y, Cb, Cr (0 and QPc(0) for I_PCM)
    int8_t lf_idc, lf_alpha, lf_beta;  // the slice's deblocking controls, offsets doubled
    int8_t ref_idx[2][16];  // ref_idx per list and 4x4 block, -1 where the list is unused
    int8_t i4mode[16];      // Intra4x4PredMode per 4x4 block (raster), -1 otherwise
    uint8_t nnz[24];        // TotalCoeff per luma 4x4 block (raster), Cb, Cr 4x4 blocks
    uint8_t mvd[2][16][2];  // |mvd| per list and 4x4 block (clamped to 127), for CABAC's ctxIdxInc
    uint32_t cbf;           // coded_block_flag (CABAC): luma 4x4 blocks (raster) bits 0-15,
                            // luma DC 16, chroma DC 17-18, chroma AC 19-26 (Cb, then Cr)
    uint16_t nonzero;       // luma 4x4 blocks (raster) of a transform block with coefficients
    int8_t t8x8;            // transform_size_8x8_flag
    int8_t chroma_mode;     // intra_chroma_pred_mode
    uint8_t cbp;            // coded_block_pattern (I_PCM: 0x2F)
    uint8_t direct8;        // the 8x8 blocks predicted in direct mode (bits 0-3)
    uint8_t direct16;       // B_Skip or B_Direct_16x16
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
    kErrCabac = -17,
};

// The slice's parameters (params[] of the entry points).
struct Params {
    int mbw, mbh, slice, first_mb, slice_type, qp, num_ref, cqp_offset[2], constrained_intra;
    int lf_idc, lf_alpha, lf_beta, mb_count, cabac, cabac_init_idc, t8x8_mode;
    // The scaling lists in raster order: 4x4 Intra Y, Cb, Cr, Inter Y, Cb,
    // Cr; 8x8 Intra Y, Inter Y.
    int w4[6][16], w8[2][64];
    // B slices: num_ref_idx_l1_active, direct_spatial_mv_pred_flag,
    // direct_8x8_inference_flag. Weighted prediction: 0 default, 1 explicit
    // (weights[]), 2 implicit; the explicit table's log2 denominators.
    int num_ref1, direct_spatial, direct_8x8, weight_mode, luma_denom, chroma_denom;
    // PicOrderCnt of the picture and of each entry of lists 0 and 1, and
    // whether each entry is a long-term reference.
    int cur_poc, poc[2][32], long_term[2][32];
    // The explicit weights: per list and ref_idx, luma weight and offset,
    // Cb's, Cr's.
    int weights[2][32][6];
};

const int kParamHead = 17, kParamInts = kParamHead + 6 * 16 + 2 * 64 + 6 + 1 + 4 * 32 + 2 * 32 * 6;

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
    c.cabac = p[14];
    c.cabac_init_idc = p[15];
    c.t8x8_mode = p[16];
    const int32_t* q = p + kParamHead;
    std::memcpy(c.w4, q, sizeof(c.w4));
    q += 6 * 16;
    std::memcpy(c.w8, q, sizeof(c.w8));
    q += 2 * 64;
    c.num_ref1 = q[0];
    c.direct_spatial = q[1];
    c.direct_8x8 = q[2];
    c.weight_mode = q[3];
    c.luma_denom = q[4];
    c.chroma_denom = q[5];
    c.cur_poc = q[6];
    q += 7;
    std::memcpy(c.poc, q, sizeof(c.poc));
    q += 2 * 32;
    std::memcpy(c.long_term, q, sizeof(c.long_term));
    q += 2 * 32;
    std::memcpy(c.weights, q, sizeof(c.weights));
    return c;
}

bool valid(const Params& c) {
    const bool b = c.slice_type == 1;
    return c.mbw > 0 && c.mbh > 0 && c.mbw <= 1024 && c.mbh <= 1024 && c.slice > 0 &&
           c.first_mb >= 0 && c.first_mb < c.mbw * c.mbh &&
           (c.slice_type == 0 || c.slice_type == 1 || c.slice_type == 2) &&
           c.qp >= 0 && c.qp <= 51 && c.num_ref >= (c.slice_type == 2 ? 0 : 1) && c.num_ref <= 32 &&
           c.num_ref1 >= (b ? 1 : 0) && c.num_ref1 <= (b ? 32 : 0) &&
           std::abs(c.cqp_offset[0]) <= 12 && std::abs(c.cqp_offset[1]) <= 12 && c.lf_idc >= 0 &&
           c.lf_idc <= 2 && std::abs(c.lf_alpha) <= 12 && std::abs(c.lf_beta) <= 12 &&
           (c.cabac == 0 || c.cabac == 1) && c.cabac_init_idc >= 0 && c.cabac_init_idc <= 2 &&
           (c.t8x8_mode == 0 || c.t8x8_mode == 1) && c.weight_mode >= 0 && c.weight_mode <= 2 &&
           c.luma_denom >= 0 && c.luma_denom <= 7 && c.chroma_denom >= 0 && c.chroma_denom <= 7 &&
           std::all_of(&c.w4[0][0], &c.w4[0][0] + 96, [](int v) { return v > 0 && v < 256; }) &&
           std::all_of(&c.w8[0][0], &c.w8[0][0] + 128, [](int v) { return v > 0 && v < 256; }) &&
           std::all_of(&c.weights[0][0][0], &c.weights[0][0][0] + 2 * 32 * 6,
                       [](int v) { return v >= -128 && v <= 128; });
}

// A neighbour's motion: ref -2 not available, -1 intra (or not predicted).
struct Motion {
    int ref, x, y;
};

// The prediction of an inter macroblock as parsed or chosen: its shape,
// each partition's or sub-macroblock's lists (bit 0 list 0, bit 1 list 1;
// 0 direct), reference indices and, per (sub-)partition in decoding order,
// motion vector differences.
struct MbPred {
    int shape = 0;            // 0 16x16, 1 16x8, 2 8x16, 3 8x8 (sub-macroblocks)
    int mode[4] = {1, 1, 1, 1};
    int sub[4] = {0, 0, 0, 0};  // sub-partitions: 0 8x8, 1 8x4, 2 4x8, 3 4x4
    int ref[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    int mvd[2][16][2] = {};
    bool ref0 = false;        // P_8x8ref0
    bool direct16 = false;    // B_Skip, B_Direct_16x16
    int groups() const { return shape == 0 ? 1 : (shape < 3 ? 2 : 4); }
};

// The partitions of P macroblock types 0-2 as (x, y, w, h).
const int kParts[3][2][4] = {{{0, 0, 16, 16}, {0, 0, 0, 0}},
                             {{0, 0, 16, 8}, {0, 8, 16, 8}},
                             {{0, 0, 8, 16}, {8, 0, 8, 16}}};
const int kSubParts[4] = {1, 2, 2, 4};
// Sub-partition k of sub-partition shape t inside its 8x8: (x, y, w, h).
void sub_part(int t, int k, int* x, int* y, int* w, int* h) {
    *w = t == 0 || t == 1 ? 8 : 4;
    *h = t == 0 || t == 2 ? 8 : 4;
    *x = t == 2 || t == 3 ? 4 * (k & 1) : 0;
    *y = t == 1 ? 4 * k : (t == 3 ? 4 * (k >> 1) : 0);
}
// The lists of each partition of B mb_types 4-21 (Table 7-14), in pairs.
const uint8_t kBPairs[9][2] = {{1, 1}, {2, 2}, {1, 2}, {2, 1}, {1, 3}, {2, 3}, {3, 1}, {3, 2}, {3, 3}};

// A B macroblock's prediction from its mb_type 0-22 (Table 7-14).
MbPred b_mb_pred(int t) {
    MbPred m;
    if (t == 0) {
        m.shape = 3;
        m.direct16 = true;
        std::fill(m.mode, m.mode + 4, 0);
    } else if (t < 4) {
        m.mode[0] = t;
    } else if (t < 22) {
        m.shape = t % 2 ? 2 : 1;
        m.mode[0] = kBPairs[(t - 4) / 2][0];
        m.mode[1] = kBPairs[(t - 4) / 2][1];
    } else {
        m.shape = 3;
    }
    return m;
}
// A B macroblock's mb_type from its prediction.
int b_mb_type(const MbPred& m) {
    if (m.direct16) return 0;
    if (m.shape == 0) return m.mode[0];
    if (m.shape == 3) return 22;
    for (int p = 0; p < 9; ++p)
        if (kBPairs[p][0] == m.mode[0] && kBPairs[p][1] == m.mode[1]) return 4 + 2 * p + (m.shape == 2);
    return -1;
}
// Sub-macroblock k's lists and shape from its B sub_mb_type 0-12 (Table 7-18), and back.
void b_sub(MbPred* m, int k, int t) {
    m->mode[k] = t == 0 ? 0 : (t < 4 ? t : (t < 10 ? 1 + (t - 4) / 2 : t - 9));
    m->sub[k] = t < 4 ? 0 : (t < 10 ? 1 + (t - 4) % 2 : 3);
}
int b_sub_type(const MbPred& m, int k) {
    const int mode = m.mode[k], sub = m.sub[k];
    if (!mode) return 0;
    return sub == 0 ? mode : (sub < 3 ? 4 + 2 * (mode - 1) + sub - 1 : 9 + mode);
}

// A (sub-)partition: luma position and size in the macroblock, and the
// partition or sub-macroblock it belongs to.
struct Rect {
    int x, y, w, h, group;
};
// The (sub-)partitions of a macroblock's prediction in decoding order (a
// direct sub-macroblock as one 8x8); their count.
int pred_rects(const MbPred& m, Rect* out) {
    int n = 0;
    if (m.shape < 3) {
        for (int k = 0; k < m.groups(); ++k) {
            const int* p = kParts[m.shape][k];
            out[n++] = {p[0], p[1], p[2], p[3], k};
        }
        return n;
    }
    for (int k = 0; k < 4; ++k) {
        if (!m.mode[k]) {
            out[n++] = {8 * (k & 1), 8 * (k >> 1), 8, 8, k};
            continue;
        }
        for (int j = 0; j < kSubParts[m.sub[k]]; ++j) {
            int x, y, w, h;
            sub_part(m.sub[k], j, &x, &y, &w, &h);
            out[n++] = {x + 8 * (k & 1), y + 8 * (k >> 1), w, h, k};
        }
    }
    return n;
}
// The 8x8 blocks (bits) of partition or sub-macroblock k of shape `shape`.
inline int group_blocks(int shape, int k) {
    return shape == 0 ? 15 : (shape == 1 ? 3 << (2 * k) : (shape == 2 ? 5 << k : 1 << k));
}
// The top-left luma sample of partition or sub-macroblock k of shape `shape`.
inline void group_origin(int shape, int k, int* x, int* y) {
    *x = shape == 2 ? 8 * k : (shape == 3 ? 8 * (k & 1) : 0);
    *y = shape == 1 ? 8 * k : (shape == 3 ? 8 * (k >> 1) : 0);
}

// What the decoder and the encoder share: the picture, its state, the
// neighbours, prediction and reconstruction.
struct Codec {
    Params c;
    const uint8_t* const* refs[2];  // 3 planes per reference index, lists 0 and 1
    const int32_t* ref_ids[2];      // an id per reference index naming its picture
    const MbState* col;             // the state of RefPicList1[0] (B slices)
    uint8_t* pic[3];
    int ys, cs;                  // luma and chroma strides (the coded width)
    MbState* st;
    int mbx = 0, mby = 0, addr = 0;
    MbState* cur = nullptr;
    uint16_t done = 0;           // the current macroblock's 4x4 blocks with motion
    bool avail_a = false, avail_b = false, avail_c = false, avail_d = false;  // for intra
    // LevelScale4x4 and LevelScale8x8 (8.5.9) of each scaling list (Params'
    // order), qP % 6 and raster position.
    int32_t ls4[6][6][16], ls8[2][6][64];
    int8_t ref8[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};  // the current macroblock's ref_idx per 8x8, as parsed
    // Temporal direct's scale of each refIdxL0 (256: the vector itself) and
    // the implicit weight w0 of each (refIdxL0, refIdxL1).
    int temporal_scale[32];
    int implicit_w0[32][32];
    // Spatial direct's reference indices and vectors of the macroblock (8.4.1.2.2).
    bool spatial_done = false;
    int spatial_ref[2], spatial_mv[2][2];
    // The encoder's counts of direct prediction's cases: a co-located block
    // intra, predicted from its list 1, zero (spatial), a list 0 index
    // above 0 (temporal).
    int64_t* direct_counts = nullptr;

    Codec(const Params& p, const uint8_t* const* r, const int32_t* ids, const MbState* colocated,
          uint8_t* const* out, MbState* s)
        : c(p), col(colocated), st(s) {
        refs[0] = r;
        refs[1] = r ? r + 3 * c.num_ref : nullptr;
        ref_ids[0] = ids;
        ref_ids[1] = ids + c.num_ref;
        for (int k = 0; k < 3; ++k) pic[k] = out[k];
        ys = 16 * c.mbw;
        cs = 8 * c.mbw;
        for (int m = 0; m < 6; ++m) {
            for (int l = 0; l < 6; ++l)
                for (int q = 0; q < 16; ++q) ls4[l][m][q] = c.w4[l][q] * kDequant[m][dq_class(q)];
            for (int l = 0; l < 2; ++l)
                for (int q = 0; q < 64; ++q)
                    ls8[l][m][q] = c.w8[l][q] * kNormAdjust8x8[m][norm8x8_class(q)];
        }
        for (int r0 = 0; r0 < 32; ++r0) {
            const int dsf = dist_scale(c.poc[0][r0], c.poc[1][0]);
            temporal_scale[r0] = c.long_term[0][r0] || dsf == kNoScale ? 256 : dsf;
            for (int r1 = 0; r1 < 32; ++r1) {
                const int w = dist_scale(c.poc[0][r0], c.poc[1][r1]);
                const bool plain = c.long_term[0][r0] || c.long_term[1][r1] || w == kNoScale ||
                                   (w >> 2) < -64 || (w >> 2) > 128;
                implicit_w0[r0][r1] = plain ? 32 : 64 - (w >> 2);
            }
        }
    }

    // DistScaleFactor (8.4.1.2.3) of the current picture between the
    // pictures of POC poc0 and poc1; kNoScale where they have one POC.
    static constexpr int kNoScale = INT32_MIN;
    int dist_scale(int poc0, int poc1) const {
        const int td = clip3(-128, 127, poc1 - poc0);
        if (!td) return kNoScale;
        const int tb = clip3(-128, 127, c.cur_poc - poc0);
        const int tx = (16384 + std::abs(td / 2)) / td;
        return clip3(-1024, 1023, (tb * tx + 32) >> 6);
    }

    // The LevelScale4x4 of component k (0 Y, 1 Cb, 2 Cr), intra or inter.
    const int32_t* list4(int k, bool intra) const { return &ls4[(intra ? 0 : 3) + k][0][0]; }
    const int32_t* list8(bool intra) const { return &ls8[intra ? 0 : 1][0][0]; }
    int num_ref(int l) const { return l ? c.num_ref1 : c.num_ref; }

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
        std::memset(cur->ref_idx, -1, sizeof(cur->ref_idx));
        std::fill(&cur->ref_pic[0][0], &cur->ref_pic[0][0] + 32, -1);
        std::memset(ref8, 0, sizeof(ref8));
        done = 0;
        spatial_done = false;
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

    // -- CABAC's ctxIdxInc from the neighbours (9.3.3.1.1) ---------------------------
    MbState* mb_a() const {
        int lx = 0, ly = 0;
        return neighbour(-1, 0, &lx, &ly);
    }
    MbState* mb_b() const {
        int lx = 0, ly = 0;
        return neighbour(0, -1, &lx, &ly);
    }
    int skip_inc() const {
        const MbState *a = mb_a(), *b = mb_b();
        return (a && a->kind != kSkip) + (b && b->kind != kSkip);
    }
    int mb_type_i_inc() const {  // I slices: neighbours not I_NxN
        const MbState *a = mb_a(), *b = mb_b();
        return (a && a->kind != kI4x4) + (b && b->kind != kI4x4);
    }
    int mb_type_b_inc() const {  // B slices: neighbours neither B_Skip nor B_Direct_16x16
        const MbState *a = mb_a(), *b = mb_b();
        return (a && !a->direct16) + (b && !b->direct16);
    }
    int t8x8_inc() const {
        const MbState *a = mb_a(), *b = mb_b();
        return (a && a->t8x8) + (b && b->t8x8);
    }
    int chroma_mode_inc() const {
        auto cond = [](const MbState* m) { return m && m->kind <= kI16x16 && m->chroma_mode; };
        return cond(mb_a()) + cond(mb_b());
    }
    // coded_block_pattern's luma bin of 8x8 block b8, the bins so far `luma`.
    int cbp_luma_inc(int b8, int luma) const {
        auto cond = [&](int x, int y) {
            int lx = 0, ly = 0;
            const MbState* m = neighbour(x, y, &lx, &ly);
            if (!m) return 0;
            const int n8 = (ly >> 3) * 2 + (lx >> 3);
            return ((m == cur ? luma : m->cbp) >> n8 & 1) ? 0 : 1;
        };
        const int x = 8 * (b8 & 1), y = 8 * (b8 >> 1);
        return cond(x - 1, y) + 2 * cond(x, y - 1);
    }
    int cbp_chroma_inc(int bin) const {
        auto cond = [&](const MbState* m) {
            return m && (bin ? (m->cbp >> 4) == 2 : (m->cbp >> 4) != 0);
        };
        return cond(mb_a()) + 2 * cond(mb_b()) + 4 * bin;
    }
    // coded_block_flag's condTermFlagN of bit `bit` of the neighbour m.
    int cbf_cond(const MbState* m, int bit) const {
        if (!m) return cur->kind <= kIPCM;
        if (m->kind == kIPCM) return 1;
        return m->cbf >> bit & 1;
    }
    // Of the luma 4x4 block (bx, by), the luma DC, chroma DC k, chroma AC
    // block (bx, by) of component k.
    int cbf_luma_inc(int bx, int by) const {
        int ax = 0, ay = 0, bx2 = 0, by2 = 0;
        const MbState* a = neighbour(4 * bx - 1, 4 * by, &ax, &ay);
        const MbState* b = neighbour(4 * bx, 4 * by - 1, &bx2, &by2);
        return cbf_cond(a, (ay >> 2) * 4 + (ax >> 2)) + 2 * cbf_cond(b, (by2 >> 2) * 4 + (bx2 >> 2));
    }
    int cbf_dc_inc(int bit) const { return cbf_cond(mb_a(), bit) + 2 * cbf_cond(mb_b(), bit); }
    int cbf_chroma_ac_inc(int k, int bx, int by) const {
        int ax = 0, ay = 0, bx2 = 0, by2 = 0;
        const MbState* a = neighbour(8 * bx - 1, 8 * by, &ax, &ay);
        const MbState* b = neighbour(8 * bx, 8 * by - 1, &bx2, &by2);
        return cbf_cond(a, 19 + 4 * k + (ay >> 3) * 2 + (ax >> 3)) +
               2 * cbf_cond(b, 19 + 4 * k + (by2 >> 3) * 2 + (bx2 >> 3));
    }
    // ref_idx_lX of the partition at (x, y): neighbours with ref_idx > 0,
    // not predicted in direct mode.
    int ref_idx_inc(int l, int x, int y) const {
        auto cond = [&](int px, int py) {
            int lx = 0, ly = 0;
            const MbState* m = neighbour(px, py, &lx, &ly);
            if (!m) return 0;
            const int b8 = (ly >> 3) * 2 + (lx >> 3);
            if (m == cur) return ref8[l][b8] > 0 ? 1 : 0;
            return m->kind == kInter && !(m->direct8 >> b8 & 1) &&
                           m->ref_idx[l][(ly >> 2) * 4 + (lx >> 2)] > 0 ? 1 : 0;
        };
        return cond(x - 1, y) + 2 * cond(x, y - 1);
    }
    // mvd_lX component `comp` of the partition at (x, y).
    int mvd_inc(int l, int x, int y, int comp) const {
        auto absmvd = [&](int px, int py) {
            int lx = 0, ly = 0;
            const MbState* m = neighbour(px, py, &lx, &ly);
            return m ? m->mvd[l][(ly >> 2) * 4 + (lx >> 2)][comp] : 0;
        };
        const int sum = absmvd(x - 1, y) + absmvd(x, y - 1);
        return sum < 3 ? 0 : (sum > 32 ? 2 : 1);
    }
    void set_mvd(int l, const Rect& p, int dx, int dy) {
        for (int by = p.y >> 2; by < (p.y + p.h) >> 2; ++by)
            for (int bx = p.x >> 2; bx < (p.x + p.w) >> 2; ++bx) {
                cur->mvd[l][by * 4 + bx][0] = static_cast<uint8_t>(std::min(127, std::abs(dx)));
                cur->mvd[l][by * 4 + bx][1] = static_cast<uint8_t>(std::min(127, std::abs(dy)));
            }
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
    // The motion of list l at luma position (x, y): ref -2 not available, -1
    // intra or the list unused (its vector then 0).
    Motion motion_at(int l, int x, int y) const {
        int lx = 0, ly = 0;
        const MbState* m = neighbour(x, y, &lx, &ly);
        const int b = (ly >> 2) * 4 + (lx >> 2);
        if (!m || (m == cur && !(done >> b & 1))) return {-2, 0, 0};
        if (m->kind <= kIPCM) return {-1, 0, 0};
        return {m->ref_idx[l][b], m->mv[l][b][0], m->mv[l][b][1]};
    }

    // mvpLX of the partition at (x, y), w x h luma samples, with ref_idx ref.
    void pred_mv(int l, int x, int y, int w, int h, int ref, int* mx, int* my) const {
        const Motion a = motion_at(l, x - 1, y), b = motion_at(l, x, y - 1);
        Motion cc = motion_at(l, x + w, y - 1);
        if (cc.ref == -2) cc = motion_at(l, x - 1, y - 1);
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
        const Motion a = motion_at(0, -1, 0), b = motion_at(0, 0, -1);
        if (a.ref == -2 || b.ref == -2 || (a.ref == 0 && !a.x && !a.y) ||
            (b.ref == 0 && !b.x && !b.y)) {
            *mx = *my = 0;
            return;
        }
        pred_mv(0, 0, 0, 16, 16, 0, mx, my);
    }

    // Both lists' motion of the blocks of (x, y, w, h) (ref -1: list unused).
    void set_motion(int x, int y, int w, int h, const int* ref, const int (*mv)[2]) {
        for (int by = y >> 2; by < (y + h) >> 2; ++by)
            for (int bx = x >> 2; bx < (x + w) >> 2; ++bx) {
                const int b = by * 4 + bx;
                for (int l = 0; l < 2; ++l) {
                    cur->ref_idx[l][b] = static_cast<int8_t>(ref[l]);
                    cur->ref_pic[l][b] = ref[l] >= 0 ? ref_ids[l][ref[l]] : -1;
                    cur->mv[l][b][0] = static_cast<int16_t>(ref[l] >= 0 ? mv[l][0] : 0);
                    cur->mv[l][b][1] = static_cast<int16_t>(ref[l] >= 0 ? mv[l][1] : 0);
                }
                done |= uint16_t(1) << b;
            }
    }

    // Spatial direct's reference indices and vectors of the macroblock
    // (8.4.1.2.2), from its neighbours A, B and C (or D).
    void spatial_pred() {
        for (int l = 0; l < 2; ++l) {
            const Motion a = motion_at(l, -1, 0), b = motion_at(l, 0, -1);
            Motion cc = motion_at(l, 16, -1);
            if (cc.ref == -2) cc = motion_at(l, -1, -1);
            auto min_positive = [](int p, int q) { return p >= 0 && q >= 0 ? std::min(p, q) : std::max(p, q); };
            spatial_ref[l] = std::max(-1, min_positive(a.ref, min_positive(b.ref, cc.ref)));
            spatial_mv[l][0] = spatial_mv[l][1] = 0;
            if (spatial_ref[l] >= 0)
                pred_mv(l, 0, 0, 16, 16, spatial_ref[l], &spatial_mv[l][0], &spatial_mv[l][1]);
        }
        if (spatial_ref[0] < 0 && spatial_ref[1] < 0) spatial_ref[0] = spatial_ref[1] = 0;
        spatial_done = true;
    }

    // The lowest index of list 0 naming picture `id` (MapColToList0); 0, as
    // FFmpeg takes, where list 0 does not hold it.
    int map_col_to_list0(int id) const {
        for (int i = 0; i < c.num_ref; ++i)
            if (ref_ids[0][i] == id) return i;
        return 0;
    }

    // The motion of 8x8 block b8 predicted in direct mode (8.4.1.2): spatial
    // or temporal, from the co-located 4x4 blocks (the corners with
    // direct_8x8_inference_flag).
    int direct8(int b8) {
        if (!col || !refs[1][0]) return kErrMissing;
        const MbState& cm = col[addr];
        if (c.direct_spatial && !spatial_done) spatial_pred();
        for (int k = 0; k < 4; ++k) {
            const int bx = 2 * (b8 & 1) + (k & 1), by = 2 * (b8 >> 1) + (k >> 1);
            const int cb = c.direct_8x8 ? 12 * (b8 >> 1) + 3 * (b8 & 1) : by * 4 + bx;
            // mvCol and refIdxCol: list 0's where the co-located block uses
            // it, else list 1's; none for an intra macroblock.
            const bool intra = cm.kind <= kIPCM;
            const int l_col = cm.ref_idx[0][cb] >= 0 ? 0 : 1;
            const int ref_col = intra ? -1 : cm.ref_idx[l_col][cb];
            const int mvc[2] = {intra ? 0 : cm.mv[l_col][cb][0], intra ? 0 : cm.mv[l_col][cb][1]};
            int ref[2], mv[2][2];
            bool zeroed = false;  // a vector colZeroFlag set to 0
            if (c.direct_spatial) {
                const bool col_zero = !c.long_term[1][0] && ref_col == 0 && std::abs(mvc[0]) <= 1 &&
                                      std::abs(mvc[1]) <= 1;
                for (int l = 0; l < 2; ++l) {
                    ref[l] = spatial_ref[l];
                    const bool zero = ref[l] < 0 || (ref[l] == 0 && col_zero);
                    zeroed = zeroed || (ref[l] == 0 && col_zero && (spatial_mv[l][0] || spatial_mv[l][1]));
                    mv[l][0] = zero ? 0 : spatial_mv[l][0];
                    mv[l][1] = zero ? 0 : spatial_mv[l][1];
                }
            } else {
                ref[0] = ref_col < 0 ? 0 : map_col_to_list0(cm.ref_pic[l_col][cb]);
                ref[1] = 0;
                const int scale = temporal_scale[ref[0]];
                for (int j = 0; j < 2; ++j) {
                    mv[0][j] = (scale * mvc[j] + 128) >> 8;
                    mv[1][j] = mv[0][j] - mvc[j];
                }
            }
            if ((ref[0] >= 0 && !refs[0][3 * ref[0]]) || (ref[1] >= 0 && !refs[1][3 * ref[1]]))
                return kErrMissing;
            if (direct_counts) {
                direct_counts[0] += intra;
                direct_counts[1] += !intra && l_col == 1;
                direct_counts[2] += zeroed;
                direct_counts[3] += !c.direct_spatial && ref[0] > 0;
            }
            set_motion(4 * bx, 4 * by, 4, 4, ref, mv);
        }
        cur->direct8 |= static_cast<uint8_t>(1 << b8);
        return kOk;
    }

    // The motion of each (sub-)partition of `m` in decoding order, with the
    // differences parsed, or (encode) the vectors `target` wanted, whose
    // differences it fills in.
    int derive(MbPred& m, const int (*target)[16][2] = nullptr) {
        Rect parts[16];
        const int n = pred_rects(m, parts);
        for (int i = 0; i < n; ++i) {
            const Rect& p = parts[i];
            const int g = p.group;
            if (!m.mode[g]) {
                const int status = direct8(g);
                if (status) return status;
                continue;
            }
            int ref[2] = {-1, -1}, mv[2][2] = {{0, 0}, {0, 0}};
            for (int l = 0; l < 2; ++l) {
                if (!(m.mode[g] >> l & 1)) continue;
                ref[l] = m.ref[l][g];
                if (ref[l] < 0 || ref[l] >= num_ref(l) || !refs[l][3 * ref[l]]) return kErrMissing;
                int px, py;
                pred_mv(l, p.x, p.y, p.w, p.h, ref[l], &px, &py);
                if (target) {
                    mv[l][0] = target[l][i][0];
                    mv[l][1] = target[l][i][1];
                    m.mvd[l][i][0] = mv[l][0] - px;
                    m.mvd[l][i][1] = mv[l][1] - py;
                } else {
                    mv[l][0] = static_cast<int16_t>(px + m.mvd[l][i][0]);
                    mv[l][1] = static_cast<int16_t>(py + m.mvd[l][i][1]);
                }
            }
            set_motion(p.x, p.y, p.w, p.h, ref, mv);
        }
        cur->direct16 = m.direct16;
        return kOk;
    }

    // Whether transform_size_8x8_flag may follow an inter macroblock's
    // coded_block_pattern: no partition below 8x8, direct ones inferred so.
    bool no_sub8x8(const MbPred& m) const {
        for (int k = 0; k < 4; ++k)
            if (m.shape == 3 && (m.mode[k] ? m.sub[k] != 0 : !c.direct_8x8)) return false;
        return true;
    }

    // -- inter prediction (8.4.2) ------------------------------------------------
    // The prediction of every (sub-)partition of `m` into the picture, each
    // direct 8x8 block whole where its four 4x4 blocks move alike.
    void predict_mb(const MbPred& m) {
        Rect parts[16];
        const int n = pred_rects(m, parts);
        for (int i = 0; i < n; ++i) {
            const Rect& p = parts[i];
            if (m.mode[p.group]) {
                predict(p.x, p.y, p.w, p.h);
                continue;
            }
            const int b = (p.y >> 2) * 4 + (p.x >> 2);
            bool alike = true;
            for (int k : {1, 4, 5})
                for (int l = 0; l < 2; ++l)
                    alike = alike && cur->ref_idx[l][b + k] == cur->ref_idx[l][b] &&
                            cur->mv[l][b + k][0] == cur->mv[l][b][0] &&
                            cur->mv[l][b + k][1] == cur->mv[l][b][1];
            if (alike) {
                predict(p.x, p.y, 8, 8);
                continue;
            }
            for (int k = 0; k < 4; ++k) predict(p.x + 4 * (k & 1), p.y + 4 * (k >> 1), 4, 4);
        }
    }

    // The block at (x, y), w x h luma samples, whose motion is uniform: each
    // list's prediction from its reference (8.4.2.2), then their weighted
    // sum (8.4.2.3) into the picture.
    void predict(int x, int y, int w, int h) {
        const int W = 16 * c.mbw, H = 16 * c.mbh;
        const int px = 16 * mbx + x, py = 16 * mby + y;
        const int b = (y >> 2) * 4 + (x >> 2);
        uint8_t tmp[2][3][256];
        int refn[2];
        for (int l = 0; l < 2; ++l) {
            refn[l] = cur->ref_idx[l][b];
            if (refn[l] < 0) continue;
            const int mx = cur->mv[l][b][0], my = cur->mv[l][b][1];
            const uint8_t* const* r = refs[l] + 3 * refn[l];
            luma_mc(tmp[l][0], 16, r[0], W, H, px + (mx >> 2), py + (my >> 2), mx & 3, my & 3, w, h);
            for (int k = 1; k < 3; ++k)
                chroma_mc(tmp[l][k], 8, r[k], W / 2, H / 2, px / 2 + (mx >> 3), py / 2 + (my >> 3),
                          mx & 7, my & 7, w / 2, h / 2);
        }
        for (int k = 0; k < 3; ++k) {
            uint8_t* dst = k ? pic[k] + (py / 2) * cs + px / 2 : pic[0] + py * ys + px;
            weigh(dst, k ? cs : ys, refn[0] >= 0 ? tmp[0][k] : nullptr,
                  refn[1] >= 0 ? tmp[1][k] : nullptr, k ? 8 : 16, k ? w / 2 : w, k ? h / 2 : h, k,
                  refn);
        }
    }

    // The weighted sample prediction (8.4.2.3) of component k from the list
    // 0 and list 1 predictions p0, p1 (null: the list unused): default
    // (averaging), explicit (each list's weight and offset of its ref_idx)
    // or implicit (w0 and w1 = 64 - w0 of the pair, log2 denominator 5).
    void weigh(uint8_t* dst, int stride, const uint8_t* p0, const uint8_t* p1, int ps, int w, int h,
               int k, const int* refn) const {
        const bool bi = p0 && p1;
        const int mode = c.weight_mode == 2 && !bi ? 0 : c.weight_mode;
        if (mode == 0) {
            for (int r = 0; r < h; ++r)
                for (int q = 0; q < w; ++q)
                    dst[r * stride + q] = bi ? static_cast<uint8_t>((p0[r * ps + q] + p1[r * ps + q] + 1) >> 1)
                                             : (p0 ? p0 : p1)[r * ps + q];
            return;
        }
        if (!bi) {
            const int l = p0 ? 0 : 1, logwd = k ? c.chroma_denom : c.luma_denom;
            const int* wt = c.weights[l][refn[l]];
            const int wgt = wt[2 * k], off = wt[2 * k + 1], round = logwd ? 1 << (logwd - 1) : 0;
            const uint8_t* p = p0 ? p0 : p1;
            for (int r = 0; r < h; ++r)
                for (int q = 0; q < w; ++q)
                    dst[r * stride + q] = clip1(((p[r * ps + q] * wgt + round) >> logwd) + off);
            return;
        }
        int logwd, w0, w1, off;
        if (mode == 2) {
            logwd = 5;
            w0 = implicit_w0[refn[0]][refn[1]];
            w1 = 64 - w0;
            off = 0;
        } else {
            logwd = k ? c.chroma_denom : c.luma_denom;
            w0 = c.weights[0][refn[0]][2 * k];
            w1 = c.weights[1][refn[1]][2 * k];
            off = (c.weights[0][refn[0]][2 * k + 1] + c.weights[1][refn[1]][2 * k + 1] + 1) >> 1;
        }
        for (int r = 0; r < h; ++r)
            for (int q = 0; q < w; ++q)
                dst[r * stride + q] = clip1(
                    ((p0[r * ps + q] * w0 + p1[r * ps + q] * w1 + (1 << logwd)) >> (logwd + 1)) + off);
    }

    void luma_mc(uint8_t* dst, int ds, const uint8_t* ref, int W, int H, int x, int y, int fx,
                 int fy, int w, int h) const {
        uint8_t win[21][21];
        for (int r = 0; r < h + 5; ++r) {
            const uint8_t* row = ref + clip3(0, H - 1, y - 2 + r) * W;
            for (int k = 0; k < w + 5; ++k) win[r][k] = row[clip3(0, W - 1, x - 2 + k)];
        }
        if (!fx && !fy) {
            for (int r = 0; r < h; ++r)
                for (int k = 0; k < w; ++k) dst[r * ds + k] = win[r + 2][k + 2];
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
                dst[r * ds + k] = static_cast<uint8_t>(v);
            }
    }

    void chroma_mc(uint8_t* dst, int ds, const uint8_t* ref, int W, int H, int x, int y, int fx,
                   int fy, int w, int h) const {
        for (int r = 0; r < h; ++r) {
            const uint8_t* r0 = ref + clip3(0, H - 1, y + r) * W;
            const uint8_t* r1 = ref + clip3(0, H - 1, y + r + 1) * W;
            for (int k = 0; k < w; ++k) {
                const int x0 = clip3(0, W - 1, x + k), x1 = clip3(0, W - 1, x + k + 1);
                dst[r * ds + k] = static_cast<uint8_t>(
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

    // Intra sample availability of 8x8 block b8: left, top, top-right, top-left.
    void i8_avail(int b8, bool* l, bool* t, bool* tr, bool* tl) const {
        const int bx = b8 & 1, by = b8 >> 1;
        *l = bx || avail_a;
        *t = by || avail_b;
        *tl = bx ? (by || avail_b) : (by ? avail_a : avail_d);
        *tr = by ? !bx : (bx ? avail_c : avail_b);
    }

    // Intra_8x8 prediction of 8x8 block b8 (8.3.2.2): the reference
    // samples filtered, then mode `mode` (numbered as the 4x4 modes).
    void pred8x8(int b8, int mode) {
        bool l, t, tr, tl;
        i8_avail(b8, &l, &t, &tr, &tl);
        uint8_t* p = pic[0] + (16 * mby + 8 * (b8 >> 1)) * ys + 16 * mbx + 8 * (b8 & 1);
        int T[16] = {0}, L[8] = {0}, Q = 0;
        if (t)
            for (int i = 0; i < 16; ++i) T[i] = i < 8 || tr ? p[-ys + i] : T[7];
        if (l)
            for (int j = 0; j < 8; ++j) L[j] = p[j * ys - 1];
        if (tl) Q = p[-ys - 1];
        int top[17] = {0}, left[8] = {0};  // top[0] the corner, top[1 + x] p'[x, -1]
        int* f = top + 1;
        if (t) {
            f[0] = tl ? (Q + 2 * T[0] + T[1] + 2) >> 2 : (3 * T[0] + T[1] + 2) >> 2;
            for (int x = 1; x < 15; ++x) f[x] = (T[x - 1] + 2 * T[x] + T[x + 1] + 2) >> 2;
            f[15] = (T[14] + 3 * T[15] + 2) >> 2;
        }
        if (tl)
            top[0] = t && l ? (T[0] + 2 * Q + L[0] + 2) >> 2
                     : t   ? (3 * Q + T[0] + 2) >> 2
                     : l   ? (3 * Q + L[0] + 2) >> 2 : Q;
        if (l) {
            left[0] = tl ? (Q + 2 * L[0] + L[1] + 2) >> 2 : (3 * L[0] + L[1] + 2) >> 2;
            for (int y = 1; y < 7; ++y) left[y] = (L[y - 1] + 2 * L[y] + L[y + 1] + 2) >> 2;
            left[7] = (L[6] + 3 * L[7] + 2) >> 2;
        }
        // p'[x, y] for x == -1 or y == -1.
        auto P = [&](int x, int y) { return y < 0 ? top[1 + x] : left[y]; };
        auto f3 = [](int a, int b, int cc) { return (a + 2 * b + cc + 2) >> 2; };
        int dc = 128;
        if (mode == 2) {
            int st_ = 0, sl = 0;
            for (int i = 0; i < 8; ++i) {
                st_ += f[i];
                sl += left[i];
            }
            dc = t && l ? (st_ + sl + 8) >> 4 : l ? (sl + 4) >> 3 : t ? (st_ + 4) >> 3 : 128;
        }
        for (int y = 0; y < 8; ++y)
            for (int x = 0; x < 8; ++x) {
                int v;
                switch (mode) {
                    case 0: v = P(x, -1); break;
                    case 1: v = P(-1, y); break;
                    case 2: v = dc; break;
                    case 3:
                        v = x == 7 && y == 7 ? (P(14, -1) + 3 * P(15, -1) + 2) >> 2
                                             : f3(P(x + y, -1), P(x + y + 1, -1), P(x + y + 2, -1));
                        break;
                    case 4:
                        v = x > y   ? f3(P(x - y - 2, -1), P(x - y - 1, -1), P(x - y, -1))
                            : x < y ? f3(P(-1, y - x - 2), P(-1, y - x - 1), P(-1, y - x))
                                    : f3(P(0, -1), P(-1, -1), P(-1, 0));
                        break;
                    case 5: {
                        const int z = 2 * x - y, k = x - (y >> 1);
                        if (z >= 0 && !(z & 1))
                            v = (P(k - 1, -1) + P(k, -1) + 1) >> 1;
                        else if (z > 0)
                            v = f3(P(k - 2, -1), P(k - 1, -1), P(k, -1));
                        else if (z == -1)
                            v = f3(P(-1, 0), P(-1, -1), P(0, -1));
                        else
                            v = f3(P(-1, y - 2 * x - 1), P(-1, y - 2 * x - 2), P(-1, y - 2 * x - 3));
                        break;
                    }
                    case 6: {
                        const int z = 2 * y - x, k = y - (x >> 1);
                        if (z >= 0 && !(z & 1))
                            v = (P(-1, k - 1) + P(-1, k) + 1) >> 1;
                        else if (z > 0)
                            v = f3(P(-1, k - 2), P(-1, k - 1), P(-1, k));
                        else if (z == -1)
                            v = f3(P(-1, 0), P(-1, -1), P(0, -1));
                        else
                            v = f3(P(x - 2 * y - 1, -1), P(x - 2 * y - 2, -1), P(x - 2 * y - 3, -1));
                        break;
                    }
                    case 7: {
                        const int k = x + (y >> 1);
                        v = (y & 1) ? f3(P(k, -1), P(k + 1, -1), P(k + 2, -1))
                                    : (P(k, -1) + P(k + 1, -1) + 1) >> 1;
                        break;
                    }
                    default: {
                        const int z = x + 2 * y, k = y + (x >> 1);
                        if (z > 13)
                            v = P(-1, 7);
                        else if (z == 13)
                            v = (P(-1, 6) + 3 * P(-1, 7) + 2) >> 2;
                        else if (z & 1)
                            v = f3(P(-1, k), P(-1, k + 1), P(-1, k + 2));
                        else
                            v = (P(-1, k) + P(-1, k + 1) + 1) >> 1;
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
    // coef: raster levels of one 4x4 block; ls: its list's LevelScale4x4;
    // dc: the already scaled DC, or none (INT32_MIN: the block's own). Adds
    // the block's residual to dst.
    static void idct_add(uint8_t* dst, int stride, const int32_t* coef, int qp, const int32_t* ls,
                         int32_t dc) {
        int d[16];
        const int q6 = qp / 6;
        const int32_t* s = ls + 16 * (qp % 6);
        for (int p = 0; p < 16; ++p) {
            const int64_t v = int64_t(coef[p]) * s[p];
            d[p] = scaled(q6 >= 4 ? v * (1 << (q6 - 4)) : (v + (1 << (3 - q6))) >> (4 - q6));
        }
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

    // The 8x8 inverse transform of one row or column (8.5.13.2), in place.
    static void idct8_1d(int* x, int s) {
        const int d0 = x[0], d1 = x[s], d2 = x[2 * s], d3 = x[3 * s], d4 = x[4 * s],
                  d5 = x[5 * s], d6 = x[6 * s], d7 = x[7 * s];
        const int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
        const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
        const int a1 = -d3 + d5 - d7 - (d7 >> 1), a3 = d1 + d7 - d3 - (d3 >> 1);
        const int a5 = -d1 + d7 + d5 + (d5 >> 1), a7 = d3 + d5 + d1 + (d1 >> 1);
        const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
        x[0] = b0 + b7;
        x[s] = b2 + b5;
        x[2 * s] = b4 + b3;
        x[3 * s] = b6 + b1;
        x[4 * s] = b6 - b1;
        x[5 * s] = b4 - b3;
        x[6 * s] = b2 - b5;
        x[7 * s] = b0 - b7;
    }

    // coef: raster levels of one 8x8 block; ls: its LevelScale8x8. Adds
    // the block's residual to dst (8.5.13).
    static void idct8_add(uint8_t* dst, int stride, const int32_t* coef, int qp, const int32_t* ls) {
        int d[64];
        const int q6 = qp / 6;
        const int32_t* s = ls + 64 * (qp % 6);
        for (int p = 0; p < 64; ++p) {
            const int64_t v = int64_t(coef[p]) * s[p];
            d[p] = scaled(q6 >= 6 ? v * (1 << (q6 - 6)) : (v + (1 << (5 - q6))) >> (6 - q6));
        }
        for (int i = 0; i < 8; ++i) idct8_1d(d + 8 * i, 1);
        for (int j = 0; j < 8; ++j) idct8_1d(d + j, 8);
        for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 8; ++j)
                dst[i * stride + j] = clip1(dst[i * stride + j] + ((d[8 * i + j] + 32) >> 6));
    }

    // Luma DC of Intra16x16 (8.5.10): levels c (raster) -> scaled dcY
    // (raster); scale: LevelScale4x4(qP % 6, 0, 0) of the Intra Y list.
    // FFmpeg's x86 code for this step (ff_h264_luma_dc_dequant_idct_sse2,
    // which cv2 runs) takes a multiplier scale << (qP / 6 + 2) above 32767
    // as (it >> 7) << 7 with its rounding halved: exact where qP / 6 >= 5,
    // off by a unit now and then below that when the scaling list's DC
    // weight makes the multiplier odd above bit 6. The port rounds as cv2
    // does there.
    static void luma_dc(const int32_t* c, int qp, int scale, int32_t* out) {
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
        const int64_t qmul = int64_t(scale) << (qp / 6 + 2);
        for (int p = 0; p < 16; ++p) {
            const int64_t v = int64_t(f[p]) * scale;
            if (qmul > 32767 && qp < 30)
                out[p] = scaled((int64_t(f[p]) * static_cast<int16_t>(qmul >> 7) + 1) >> 1);
            else
                out[p] = scaled(qp >= 36 ? v * (1 << (qp / 6 - 6))
                                         : (v + (1 << (5 - qp / 6))) >> (6 - qp / 6));
        }
    }

    // Chroma DC (8.5.11): levels c[4] -> scaled dcC[4]; scale as luma_dc's,
    // of the component's list.
    static void chroma_dc(const int32_t* c, int qp, int scale, int32_t* out) {
        const int f[4] = {c[0] + c[1] + c[2] + c[3], c[0] - c[1] + c[2] - c[3],
                          c[0] + c[1] - c[2] - c[3], c[0] - c[1] - c[2] + c[3]};
        for (int p = 0; p < 4; ++p) out[p] = scaled((int64_t(f[p]) * scale * (1 << (qp / 6))) >> 5);
    }

    // The macroblock's coefficients as parsed or chosen.
    struct Residual {
        int32_t luma[16][16];     // raster block, raster position
        int32_t luma_dc[16];      // Intra16x16 DC levels, raster
        int32_t chroma_dc[2][4];
        int32_t chroma_ac[2][4][16];
        int32_t luma8[4][64];     // 8x8 blocks, raster position
        void clear() { std::memset(this, 0, sizeof(*this)); }
    };

    void add_chroma_residual(const Residual& res, int cbp_chroma) {
        if (!cbp_chroma) return;
        const bool intra = cur->kind <= kIPCM;
        for (int k = 0; k < 2; ++k) {
            const int qpc = chroma_qp(cur->qp, c.cqp_offset[k]);
            const int32_t* ls = list4(1 + k, intra);
            int32_t dc[4];
            chroma_dc(res.chroma_dc[k], qpc, ls[16 * (qpc % 6)], dc);
            uint8_t* p = pic[1 + k] + 8 * mby * cs + 8 * mbx;
            for (int b = 0; b < 4; ++b)
                idct_add(p + 4 * (b >> 1) * cs + 4 * (b & 1), cs, res.chroma_ac[k][b], qpc, ls,
                         dc[b]);
        }
    }

    // The luma residual of an inter macroblock (4x4 or 8x8 transforms).
    void add_inter_luma_residual(const Residual& res, int cbp) {
        for (int b8 = 0; b8 < 4; ++b8) {
            if (!(cbp >> b8 & 1)) continue;
            uint8_t* p = pic[0] + (16 * mby + 8 * (b8 >> 1)) * ys + 16 * mbx + 8 * (b8 & 1);
            if (cur->t8x8) {
                idct8_add(p, ys, res.luma8[b8], cur->qp, list8(false));
                continue;
            }
            for (int k = 0; k < 4; ++k) {
                const int b = (2 * (b8 >> 1) + (k >> 1)) * 4 + 2 * (b8 & 1) + (k & 1);
                idct_add(pic[0] + (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3), ys,
                         res.luma[b], cur->qp, list4(0, false), INT32_MIN);
            }
        }
    }

    void set_lf_qp(int qp_y) {
        cur->lf_qp[0] = static_cast<int8_t>(qp_y);
        cur->lf_qp[1] = static_cast<int8_t>(chroma_qp(qp_y, c.cqp_offset[0]));
        cur->lf_qp[2] = static_cast<int8_t>(chroma_qp(qp_y, c.cqp_offset[1]));
    }
};

// ---------------------------------------------------------------------------
// CABAC (9.3).
// ---------------------------------------------------------------------------

// The contexts' states (pStateIdx << 1 | valMPS) initialised for a slice
// (9.3.1.1): I slices from the I table, P slices from cabac_init_idc's.
void init_contexts(uint8_t* state, int slice_type, int init_idc, int qp) {
    const int8_t(*t)[2] = slice_type == 2 ? kCabacInitI : kCabacInitP[init_idc];
    const int q = clip3(0, 51, qp);
    for (int k = 0; k < 1024; ++k) {
        const int pre = clip3(1, 126, ((t[k][0] * q) >> 4) + t[k][1]);
        state[k] = static_cast<uint8_t>(pre <= 63 ? (63 - pre) << 1 : (pre - 64) << 1 | 1);
    }
}

// The arithmetic decoding and encoding engines (cabac.h), on this file's
// bit reader and writer.
using CabacDecoder = cabac::Decoder<Reader>;
using CabacEncoder = cabac::Encoder<Writer>;

// Each syntax element's binarisation and contexts (9.3.2, 9.3.3.1), for
// the decoder and the encoder alike: each takes the value to encode
// (ignored when decoding) and returns the value coded. On a corrupt stream
// the unbounded codes give kBad.
const int kBad = INT32_MIN;

template <class E>
struct CabacSyntax {
    E e;
    Codec* k;

    int d(int ctx, int bin) { return e.decision(ctx, bin); }
    int skip(int v) { return d((k->c.slice_type == 1 ? 24 : 11) + k->skip_inc(), v); }
    // The mb_type of an intra macroblock: 0 I_NxN, 1-24 I_16x16, 25 I_PCM;
    // of an I slice (prefix ctxIdxOffset 3), or the suffix in a P slice
    // (17) or a B slice (32).
    int mb_type_i(int v, int base) {
        const bool islice = base == 3;
        if (!d(islice ? 3 + k->mb_type_i_inc() : base, v != 0)) return 0;
        if (e.terminate(v == 25)) return 25;
        const int t = v - 1;
        int out = 1 + 12 * d(base + (islice ? 3 : 1), t >= 12);
        if (d(base + (islice ? 4 : 2), (t / 4) % 3 != 0))
            out += 4 + 4 * d(base + (islice ? 5 : 2), (t / 4) % 3 == 2);
        out += 2 * d(base + (islice ? 6 : 3), (t % 4) >> 1);
        return out + d(base + (islice ? 7 : 3), t & 1);
    }
    // The mb_type of a P slice: 0-3 P_L0_16x16, P_L0_L0_16x8, P_L0_L0_8x16,
    // P_8x8; 5 + the intra mb_type.
    int mb_type_p(int v) {
        if (d(14, v >= 5)) return 5 + mb_type_i(v - 5, 17);
        if (!d(15, v == 1 || v == 2)) return 3 * d(16, v == 3);
        return 2 - d(17, v == 1);
    }
    // The mb_type of a B slice (Table 9-37): 0-22 (Table 7-14); 23 + the
    // intra mb_type. Bins 3 on: four bits, a fifth for types 12-21.
    int mb_type_b(int v) {
        if (!d(27 + k->mb_type_b_inc(), v != 0)) return 0;
        if (!d(30, v >= 3)) return 1 + d(32, v == 2);
        const int code = v >= 23 ? 13 : (v == 22 ? 15 : (v == 11 ? 14 : (v < 11 ? v - 3 : (v + 4) >> 1)));
        int bits = d(31, code >> 3 & 1) << 3;
        bits |= d(32, code >> 2 & 1) << 2;
        bits |= d(32, code >> 1 & 1) << 1;
        bits |= d(32, code & 1);
        if (bits < 8) return bits + 3;
        if (bits == 13) return 23 + mb_type_i(v - 23, 32);
        if (bits == 14) return 11;
        if (bits == 15) return 22;
        return ((bits << 1) | d(32, (v + 4) & 1)) - 4;
    }
    int sub_mb_type(int v) {
        if (d(21, v == 0)) return 0;
        if (!d(22, v >= 2)) return 1;
        return d(23, v == 2) ? 2 : 3;
    }
    // A B slice's sub_mb_type 0-12 (Table 9-38).
    int sub_mb_type_b(int v) {
        if (!d(36, v != 0)) return 0;
        if (!d(37, v >= 3)) return 1 + d(39, v == 2);
        int type = 3;
        if (d(38, v >= 7)) {
            if (d(39, v >= 11)) return 11 + d(39, v == 12);
            type = 7;
        }
        const int rest = v - type;
        type += 2 * d(39, rest >> 1 & 1);
        return type + d(39, rest & 1);
    }
    int ref_idx(int v, int inc, int max) {
        int n = 0;
        while (d(54 + (n == 0 ? inc : (n == 1 ? 4 : 5)), v > n))
            if (++n > max) return kBad;
        return n;
    }
    // The suffix of UEGk (9.3.2.3), bypass bins.
    int ueg(int v, int k_) {
        int n = 0;
        while (e.bypass(v >= n + (1 << k_))) {
            n += 1 << k_;
            if (++k_ > 24) return kBad;
        }
        const int rest = v - n;
        while (k_--) n += e.bypass(rest >> k_ & 1) << k_;
        return n;
    }
    int mvd(int v, int comp, int inc) {
        const int base = comp ? 47 : 40, a = std::abs(v);
        if (!d(base + inc, a != 0)) return 0;
        int n = 1;
        while (n < 9 && d(base + std::min(n + 2, 6), a > n)) ++n;
        if (n == 9) {
            const int s = ueg(a - 9, 3);
            if (s == kBad) return kBad;
            n += s;
        }
        return e.bypass(v < 0) ? -n : n;
    }
    int qp_delta(int v, int inc) {
        const int code = v > 0 ? 2 * v - 1 : -2 * v;
        int n = 0;
        while (d(60 + (n == 0 ? inc : (n == 1 ? 2 : 3)), code > n))
            if (++n > 52) return kBad;
        return (n & 1) ? (n + 1) / 2 : -(n / 2);
    }
    // prev_intra*_pred_mode_flag and rem_intra*_pred_mode: -1 the predicted
    // mode, else the remainder.
    int pred_mode(int v) {
        if (d(68, v < 0)) return -1;
        int rem = d(69, v & 1);
        rem |= d(69, v >> 1 & 1) << 1;
        return rem | d(69, v >> 2 & 1) << 2;
    }
    int chroma_mode(int v) {
        if (!d(64 + k->chroma_mode_inc(), v > 0)) return 0;
        if (!d(67, v > 1)) return 1;
        return d(67, v > 2) ? 3 : 2;
    }
    int cbp(int v) {
        int luma = 0;
        for (int b8 = 0; b8 < 4; ++b8) luma |= d(73 + k->cbp_luma_inc(b8, luma), v >> b8 & 1) << b8;
        int chroma = 0;
        if (d(77 + k->cbp_chroma_inc(0), (v >> 4) != 0))
            chroma = 1 + d(77 + k->cbp_chroma_inc(1), (v >> 4) == 2);
        return luma | chroma << 4;
    }
    int t8x8(int v) { return d(399 + k->t8x8_inc(), v); }

    // residual_block_cabac (7.3.5.3.3): the block's levels in scan order,
    // coef[0..max) (read or written), of ctxBlockCat `cat` with
    // coded_block_flag's ctxIdxInc `cbf_inc` (none for cat 5). Returns the
    // count of nonzero levels, or kBad.
    int block(int cat, int cbf_inc, int32_t* coef, int max) {
        static const int kSigOffset[5] = {0, 15, 29, 44, 47}, kAbsOffset[5] = {0, 10, 20, 30, 39};
        int last = -1;
        if (E::kEncode) {
            for (int i = 0; i < max; ++i)
                if (coef[i]) last = i;
        } else {
            std::memset(coef, 0, sizeof(int32_t) * max);
        }
        if (cat != 5 && !d(85 + 4 * cat + cbf_inc, last >= 0)) return 0;
        const int sig = cat == 5 ? 402 : 105 + kSigOffset[cat];
        const int lst = cat == 5 ? 417 : 166 + kSigOffset[cat];
        const int abs_base = cat == 5 ? 426 : 227 + kAbsOffset[cat];
        int pos[64], n = 0, i = 0;
        for (; i < max - 1; ++i) {
            const int inc = cat == 5 ? kSig8x8Inc[i] : (cat == 3 ? std::min(i, 2) : i);
            if (!d(sig + inc, E::kEncode && coef[i] != 0)) continue;
            pos[n++] = i;
            const int linc = cat == 5 ? kLast8x8Inc[i] : (cat == 3 ? std::min(i, 2) : i);
            if (d(lst + linc, i == last)) break;
        }
        if (i == max - 1) pos[n++] = i;
        int gt1 = 0, eq1 = 0;
        for (int j = n - 1; j >= 0; --j) {
            const int a = E::kEncode ? std::abs(coef[pos[j]]) - 1 : 0;
            int v = 0;
            if (d(abs_base + (gt1 ? 0 : std::min(4, 1 + eq1)), a > 0)) {
                const int inc = 5 + std::min(4 - (cat == 3), gt1);
                v = 1;
                while (v < 14 && d(abs_base + inc, a > v)) ++v;
                if (v == 14) {
                    const int s = ueg(a - 14, 0);
                    if (s == kBad) return kBad;
                    v += s;
                }
            }
            if (v)
                ++gt1;
            else
                ++eq1;
            const int negative = e.bypass(E::kEncode && coef[pos[j]] < 0);
            if (!E::kEncode) coef[pos[j]] = negative ? -(v + 1) : v + 1;
        }
        return n;
    }
};

// ---------------------------------------------------------------------------
// The decoder.
// ---------------------------------------------------------------------------

struct Decoder : Codec {
    Reader& r;
    int qp_prev;
    bool qp_delta_nonzero = false;  // the previous macroblock's mb_qp_delta (CABAC)
    Residual res;
    CabacSyntax<CabacDecoder> syn;

    Decoder(const Params& p, const uint8_t* const* refs_, const int32_t* ids, const MbState* colocated,
            uint8_t* const* out, MbState* s, Reader& rd)
        : Codec(p, refs_, ids, colocated, out, s), r(rd), qp_prev(p.qp) {
        syn.k = this;
        syn.e.r = &r;
        syn.e.limit = r.size_bits + 8 * kSlack;
    }

    int run() { return c.cabac ? run_cabac() : run_cavlc(); }

    int run_cavlc() {
        const int total = c.mbw * c.mbh;
        int a = c.first_mb;
        bool more = true;
        while (more) {
            if (c.slice_type != 2) {
                const int64_t skip = r.ue();
                if (skip < 0) return kErrGolomb;
                if (r.overrun()) return kErrOverrun;
                if (skip > total - a) return kErrSliceEnd;
                for (int64_t k = 0; k < skip; ++k) {
                    int status = begin(a++);
                    if (!status) status = decode_skip();
                    if (status) return status;
                }
                if (skip > 0 && !r.more_rbsp()) break;
            }
            if (a >= total) return kErrSliceEnd;
            int status = begin(a++);
            if (!status) status = decode_mb();
            if (status) return status;
            if (r.overrun()) return kErrOverrun;
            more = r.more_rbsp();
        }
        return kOk;
    }

    int run_cabac() {
        r.pos = (r.pos + 7) & ~int64_t(7);  // cabac_alignment_one_bit
        init_contexts(syn.e.state, c.slice_type, c.cabac_init_idc, c.qp);
        syn.e.start();
        const int total = c.mbw * c.mbh;
        for (int a = c.first_mb;; ++a) {
            if (a >= total) return kErrSliceEnd;
            int status = begin(a);
            if (!status) status = c.slice_type != 2 && syn.skip(0) ? decode_skip() : decode_mb_cabac();
            if (status) return status;
            if (syn.e.over) return kErrOverrun;
            if (syn.e.terminate()) break;  // end_of_slice_flag
        }
        return syn.e.over ? kErrOverrun : kOk;
    }

    int begin(int a) {
        if (st[a].slice) return kErrOverlap;
        start_mb(a);
        return kOk;
    }

    // P_Skip (list 0's ref_idx 0, its vector predicted) or B_Skip (direct).
    int decode_skip() {
        MbPred m;
        if (c.slice_type == 1) {
            m = b_mb_pred(0);
            const int status = derive(m);
            if (status) return status;
        } else {
            if (!refs[0][0]) return kErrMissing;
            int ref[2] = {0, -1}, mv[2][2] = {{0, 0}, {0, 0}};
            skip_mv(&mv[0][0], &mv[0][1]);
            set_motion(0, 0, 16, 16, ref, mv);
        }
        cur->kind = kSkip;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(qp_prev);
        qp_delta_nonzero = false;
        predict_mb(m);
        return kOk;
    }

    // ref_idx_lX, te(v).
    int read_ref(int l) {
        if (num_ref(l) == 2) return !r.get1();
        const int64_t v = r.ue();
        return v < 0 || v >= num_ref(l) ? -1 : static_cast<int>(v);
    }

    // An intra mode: `rem` -1 the predicted one.
    static int intra_mode(int pred, int rem) { return rem < 0 ? pred : (rem < pred ? rem : rem + 1); }

    void set_i8mode(int b8, int mode) {
        for (int k = 0; k < 4; ++k)
            cur->i4mode[(2 * (b8 >> 1) + (k >> 1)) * 4 + 2 * (b8 & 1) + (k & 1)] =
                static_cast<int8_t>(mode);
    }

    int decode_mb() {
        int64_t mb_type = r.ue();
        if (mb_type < 0) return kErrGolomb;
        const int inter_types = c.slice_type == 0 ? 5 : (c.slice_type == 1 ? 23 : 0);
        const bool intra = mb_type >= inter_types;
        if (intra) mb_type -= inter_types;
        if (intra && mb_type > 25) return kErrMbType;
        res.clear();
        int cbp = 0;
        if (intra && mb_type == 25) return decode_pcm();
        if (intra) {
            cur->kind = mb_type == 0 ? kI4x4 : kI16x16;
            if (cur->kind == kI4x4) {
                if (c.t8x8_mode) cur->t8x8 = static_cast<int8_t>(r.get1());
                for (int k = 0; k < (cur->t8x8 ? 4 : 16); ++k) {
                    const int bx = cur->t8x8 ? 2 * (k & 1) : kBlkX[k];
                    const int by = cur->t8x8 ? 2 * (k >> 1) : kBlkY[k];
                    const int rem = r.get1() ? -1 : static_cast<int>(r.get(3));
                    const int mode = intra_mode(pred_i4mode(bx, by), rem);
                    if (cur->t8x8)
                        set_i8mode(k, mode);
                    else
                        cur->i4mode[by * 4 + bx] = static_cast<int8_t>(mode);
                }
            }
            const int64_t chroma_mode = r.ue();
            if (chroma_mode < 0 || chroma_mode > 3) return kErrIntraMode;
            if (r.overrun()) return kErrOverrun;
            cur->chroma_mode = static_cast<int8_t>(chroma_mode);
            if (cur->kind == kI16x16) {
                cbp = i16_cbp(static_cast<int>(mb_type));
            } else {
                const int64_t code = r.ue();
                if (code < 0 || code > 47) return kErrCbp;
                cbp = kGolombToIntraCbp[code];
            }
            int status = read_qp_and_residual(cbp);
            if (status) return status;
            return reconstruct_intra(static_cast<int>(mb_type), cbp);
        }

        // Inter.
        cur->kind = kInter;
        MbPred m;
        if (c.slice_type == 1) {
            m = b_mb_pred(static_cast<int>(mb_type));
        } else {
            m.shape = std::min(3, static_cast<int>(mb_type));
            m.ref0 = mb_type == 4;
        }
        if (m.shape == 3 && !m.direct16)
            for (int k = 0; k < 4; ++k) {
                const int64_t t = r.ue();
                if (t < 0 || t > (c.slice_type == 1 ? 12 : 3)) return kErrSubMbType;
                if (c.slice_type == 1)
                    b_sub(&m, k, static_cast<int>(t));
                else
                    m.sub[k] = static_cast<int>(t);
            }
        for (int l = 0; l < 2; ++l)
            for (int g = 0; g < m.groups(); ++g)
                if ((m.mode[g] >> l & 1) && num_ref(l) > 1 && !m.ref0 &&
                    (m.ref[l][g] = read_ref(l)) < 0)
                    return kErrRefIdx;
        Rect parts[16];
        const int n = pred_rects(m, parts);
        for (int l = 0; l < 2; ++l)
            for (int i = 0; i < n; ++i) {
                if (!(m.mode[parts[i].group] >> l & 1)) continue;
                const int64_t dx = r.se(), dy = r.se();
                if (dx == INT64_MIN || dy == INT64_MIN) return kErrGolomb;
                if (r.overrun()) return kErrOverrun;
                m.mvd[l][i][0] = static_cast<int>(std::max<int64_t>(-65536, std::min<int64_t>(65536, dx)));
                m.mvd[l][i][1] = static_cast<int>(std::max<int64_t>(-65536, std::min<int64_t>(65536, dy)));
            }
        int status = derive(m);
        if (status) return status;
        predict_mb(m);
        const int64_t code = r.ue();
        if (code < 0 || code > 47) return kErrCbp;
        cbp = kGolombToInterCbp[code];
        if ((cbp & 15) && c.t8x8_mode && no_sub8x8(m)) cur->t8x8 = static_cast<int8_t>(r.get1());
        status = read_qp_and_residual(cbp);
        if (status) return status;
        add_inter_luma_residual(res, cbp);
        add_chroma_residual(res, cbp >> 4);
        return kOk;
    }

    // coded_block_pattern of I_16x16 mb_type t.
    static int i16_cbp(int t) { return ((t - 1) / 4 % 3) << 4 | (t >= 13 ? 15 : 0); }

    // Intra prediction and the residual, once the macroblock is parsed.
    int reconstruct_intra(int mb_type, int cbp) {
        static const int kChromaToI16[4] = {2, 1, 0, 3};
        if (!i16_mode_ok(kChromaToI16[cur->chroma_mode], avail_a, avail_b, avail_d))
            return kErrIntraMode;
        if (cur->kind == kI4x4 && cur->t8x8) {
            for (int b8 = 0; b8 < 4; ++b8) {
                bool l, t, tr, tl;
                i8_avail(b8, &l, &t, &tr, &tl);
                const int mode = cur->i4mode[(2 * (b8 >> 1)) * 4 + 2 * (b8 & 1)];
                if (!i4_mode_ok(mode, l, t, tl)) return kErrIntraMode;
                pred8x8(b8, mode);
                if (cbp >> b8 & 1)
                    idct8_add(pic[0] + (16 * mby + 8 * (b8 >> 1)) * ys + 16 * mbx + 8 * (b8 & 1), ys,
                              res.luma8[b8], cur->qp, list8(true));
            }
        } else if (cur->kind == kI4x4) {
            for (int k = 0; k < 16; ++k) {
                const int bx = kBlkX[k], by = kBlkY[k], b = by * 4 + bx;
                bool l, t, tr, tl;
                i4_avail(bx, by, &l, &t, &tr, &tl);
                if (!i4_mode_ok(cur->i4mode[b], l, t, tl)) return kErrIntraMode;
                pred4x4(bx, by, cur->i4mode[b]);
                if (cbp >> (b >> 3 << 1 | (b & 3) >> 1) & 1)
                    idct_add(pic[0] + (16 * mby + 4 * by) * ys + 16 * mbx + 4 * bx, ys,
                             res.luma[b], cur->qp, list4(0, true), INT32_MIN);
            }
        } else {
            const int i16mode = (mb_type - 1) % 4;
            if (!i16_mode_ok(i16mode, avail_a, avail_b, avail_d)) return kErrIntraMode;
            pred16x16(i16mode);
            int32_t dc[16];
            const int32_t* ls = list4(0, true);
            luma_dc(res.luma_dc, cur->qp, ls[16 * (cur->qp % 6)], dc);
            for (int b = 0; b < 16; ++b)
                idct_add(pic[0] + (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3), ys,
                         res.luma[b], cur->qp, ls, dc[b]);
        }
        pred_chroma(cur->chroma_mode);
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
        std::memset(cur->nnz, 16, 24);
        cur->cbf = ~0u;
        cur->nonzero = 0xFFFF;
        cur->cbp = 0x2F;
        qp_delta_nonzero = false;
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
        cur->cbp = static_cast<uint8_t>(cbp);
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
                if (cur->t8x8) {
                    // An 8x8 block as four interleaved 4x4 scans (7.3.5.3.1).
                    for (int i = 0; i < 16; ++i) res.luma8[k >> 2][kZigzag8x8[4 * i + (k & 3)]] = levels[i];
                    if (total) cur->nonzero |= mask8(k >> 2);
                } else {
                    for (int i = 0; i < 16; ++i) res.luma[b][kZigzag[i]] = levels[i];
                }
            }
            if (total && !cur->t8x8) cur->nonzero |= uint16_t(1) << b;
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

    // -- CABAC ------------------------------------------------------------------------
    int decode_mb_cabac() {
        const int inter_types = c.slice_type == 0 ? 5 : (c.slice_type == 1 ? 23 : 0);
        int mb_type = c.slice_type == 0 ? syn.mb_type_p(0)
                                        : (c.slice_type == 1 ? syn.mb_type_b(0) : syn.mb_type_i(0, 3));
        const bool intra = mb_type >= inter_types;
        if (intra) mb_type -= inter_types;
        res.clear();
        if (intra && mb_type == 25) {
            const int status = decode_pcm();
            syn.e.start();
            return status;
        }
        int cbp;
        if (intra) {
            cur->kind = mb_type == 0 ? kI4x4 : kI16x16;
            if (cur->kind == kI4x4) {
                if (c.t8x8_mode) cur->t8x8 = static_cast<int8_t>(syn.t8x8(0));
                for (int k = 0; k < (cur->t8x8 ? 4 : 16); ++k) {
                    const int bx = cur->t8x8 ? 2 * (k & 1) : kBlkX[k];
                    const int by = cur->t8x8 ? 2 * (k >> 1) : kBlkY[k];
                    const int mode = intra_mode(pred_i4mode(bx, by), syn.pred_mode(0));
                    if (cur->t8x8)
                        set_i8mode(k, mode);
                    else
                        cur->i4mode[by * 4 + bx] = static_cast<int8_t>(mode);
                }
            }
            cur->chroma_mode = static_cast<int8_t>(syn.chroma_mode(0));
            cbp = cur->kind == kI16x16 ? i16_cbp(mb_type) : syn.cbp(0);
            const int status = cabac_residual(cbp);
            if (status) return status;
            return reconstruct_intra(mb_type, cbp);
        }
        cur->kind = kInter;
        MbPred m;
        if (c.slice_type == 1)
            m = b_mb_pred(mb_type);
        else
            m.shape = mb_type;
        if (m.shape == 3 && !m.direct16)
            for (int k = 0; k < 4; ++k) {
                if (c.slice_type == 1)
                    b_sub(&m, k, syn.sub_mb_type_b(0));
                else
                    m.sub[k] = syn.sub_mb_type(0);
            }
        for (int l = 0; l < 2; ++l)
            for (int g = 0; g < m.groups(); ++g) {
                if (!(m.mode[g] >> l & 1)) continue;
                if (num_ref(l) > 1) {
                    int x, y;
                    group_origin(m.shape, g, &x, &y);
                    m.ref[l][g] = syn.ref_idx(0, ref_idx_inc(l, x, y), num_ref(l) - 1);
                    if (m.ref[l][g] == kBad) return kErrRefIdx;
                }
                for (int b8 = 0; b8 < 4; ++b8)
                    if (group_blocks(m.shape, g) >> b8 & 1) ref8[l][b8] = static_cast<int8_t>(m.ref[l][g]);
            }
        Rect parts[16];
        const int n = pred_rects(m, parts);
        for (int l = 0; l < 2; ++l)
            for (int i = 0; i < n; ++i) {
                const Rect& p = parts[i];
                if (!(m.mode[p.group] >> l & 1)) continue;
                const int dx = syn.mvd(0, 0, mvd_inc(l, p.x, p.y, 0));
                const int dy = syn.mvd(0, 1, mvd_inc(l, p.x, p.y, 1));
                if (dx == kBad || dy == kBad) return kErrCabac;
                set_mvd(l, p, dx, dy);
                m.mvd[l][i][0] = dx;
                m.mvd[l][i][1] = dy;
            }
        int status = derive(m);
        if (status) return status;
        predict_mb(m);
        cbp = syn.cbp(0);
        if ((cbp & 15) && c.t8x8_mode && no_sub8x8(m)) cur->t8x8 = static_cast<int8_t>(syn.t8x8(0));
        status = cabac_residual(cbp);
        if (status) return status;
        add_inter_luma_residual(res, cbp);
        add_chroma_residual(res, cbp >> 4);
        return kOk;
    }

    int cabac_residual(int cbp) {
        int qp = qp_prev;
        const bool prev_nonzero = qp_delta_nonzero;
        qp_delta_nonzero = false;
        if (cbp || cur->kind == kI16x16) {
            const int delta = syn.qp_delta(0, prev_nonzero);
            if (delta == kBad || delta < -26 || delta > 25) return kErrQpDelta;
            qp = (qp_prev + delta + 52) % 52;
            qp_delta_nonzero = delta != 0;
        }
        qp_prev = qp;
        cur->qp = static_cast<int8_t>(qp);
        cur->cbp = static_cast<uint8_t>(cbp);
        set_lf_qp(qp);
        int32_t lv[64];
        if (cur->kind == kI16x16) {
            const int n = syn.block(0, cbf_dc_inc(16), lv, 16);
            if (n == kBad) return kErrCabac;
            if (n) cur->cbf |= 1u << 16;
            for (int i = 0; i < 16; ++i) res.luma_dc[kZigzag[i]] = lv[i];
        }
        for (int b8 = 0; b8 < 4; ++b8) {
            if (!(cbp >> b8 & 1)) continue;
            if (cur->t8x8) {
                if (syn.block(5, 0, lv, 64) == kBad) return kErrCabac;
                for (int i = 0; i < 64; ++i) res.luma8[b8][kZigzag8x8[i]] = lv[i];
                cur->cbf |= mask8(b8);
                cur->nonzero |= mask8(b8);
                continue;
            }
            for (int k = 4 * b8; k < 4 * b8 + 4; ++k) {
                const int bx = kBlkX[k], by = kBlkY[k], b = by * 4 + bx;
                const bool i16 = cur->kind == kI16x16;
                const int n = syn.block(i16 ? 1 : 2, cbf_luma_inc(bx, by), lv, i16 ? 15 : 16);
                if (n == kBad) return kErrCabac;
                for (int i = 0; i < (i16 ? 15 : 16); ++i) res.luma[b][kZigzag[i + i16]] = lv[i];
                if (n) {
                    cur->cbf |= 1u << b;
                    cur->nonzero |= uint16_t(1) << b;
                }
                cur->nnz[b] = static_cast<uint8_t>(n);
            }
        }
        if (cbp >> 4)
            for (int k = 0; k < 2; ++k) {
                const int n = syn.block(3, cbf_dc_inc(17 + k), lv, 4);
                if (n == kBad) return kErrCabac;
                if (n) cur->cbf |= 1u << (17 + k);
                for (int i = 0; i < 4; ++i) res.chroma_dc[k][i] = lv[i];
            }
        if (cbp >> 4 == 2)
            for (int k = 0; k < 2; ++k)
                for (int b = 0; b < 4; ++b) {
                    const int n = syn.block(4, cbf_chroma_ac_inc(k, b & 1, b >> 1), lv, 15);
                    if (n == kBad) return kErrCabac;
                    for (int i = 0; i < 15; ++i) res.chroma_ac[k][b][kZigzag[i + 1]] = lv[i];
                    if (n) cur->cbf |= 1u << (19 + 4 * k + b);
                    cur->nnz[16 + 4 * k + b] = static_cast<uint8_t>(n);
                }
        return kOk;
    }
};

// ---------------------------------------------------------------------------
// Deblocking (8.7).
// ---------------------------------------------------------------------------

// Whether two vectors differ by 4 or more quarter samples in a component.
inline bool far(const int16_t* a, const int16_t* b) {
    return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4;
}

// bS of the edge between 4x4 blocks pb of p and qb of q (8.7.2.1): their
// reference pictures compared as pictures, a list unused as none; where the
// lists pair off straight or crossed, bS 1 only if the vectors differ both
// ways.
int boundary_strength(const MbState& p, int pb, const MbState& q, int qb, bool mb_edge) {
    if (p.kind <= kIPCM || q.kind <= kIPCM) return mb_edge ? 4 : 3;
    if ((p.nonzero >> pb & 1) || (q.nonzero >> qb & 1)) return 2;
    const int p0 = p.ref_pic[0][pb], p1 = p.ref_pic[1][pb], q0 = q.ref_pic[0][qb], q1 = q.ref_pic[1][qb];
    const bool straight = p0 != q0 || p1 != q1 || far(p.mv[0][pb], q.mv[0][qb]) ||
                          far(p.mv[1][pb], q.mv[1][qb]);
    if (!straight) return 0;
    if (p0 != q1 || p1 != q0) return 1;
    return far(p.mv[0][pb], q.mv[1][qb]) || far(p.mv[1][pb], q.mv[0][qb]) ? 1 : 0;
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
            if ((e == 0 && !outer) || (q.t8x8 && (e & 1))) continue;
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

// Plan record per macroblock (int32): [0] kind (0 I4x4, 1 I16x16, 2 I_PCM,
// 3 16x16, 4 16x8, 5 8x16, 6 8x8, 7 P8x8ref0, 8 P_Skip or B_Skip, 10
// B_Direct_16x16), [1] the 16x16 mode, [2] the chroma mode, [3] QP, [4:8]
// sub_mb_type per 8x8 (P's 0-3, B's 0-12), [8:12] ref_idx_l0 per 8x8
// (partitions take their first 8x8's), [12:28] the 4x4 modes (raster; an
// 8x8 block takes its first 4x4 block's), [28:60] list 0's motion vectors
// (raster 4x4 blocks; partitions take their first block's), [60] whether
// to use the 8x8 transform where the PPS allows it and the macroblock may
// (I_NxN; inter macroblocks with no partition below 8x8 and luma
// coefficients), [61:63] the lists of a B 16x16 macroblock's or each 16x8 /
// 8x16 partition's prediction (1 list 0, 2 list 1, 3 both), [64:68]
// ref_idx_l1 per 8x8, [68:100] list 1's motion vectors; the rest unused.
const int kPlanInts = 128;
// Kind 9 is I4x4 whose luma levels are given (levels[], 16 a 4x4 block in
// raster order, each block's in scan order) instead of quantised: the
// probes that read single VLC codewords back from another decoder.
enum PlanKind { kPlanI4 = 0, kPlanI16, kPlanPcm, kPlanP16, kPlanP16x8, kPlanP8x16, kPlanP8x8,
                kPlanP8x8Ref0, kPlanSkip, kPlanI4Levels, kPlanDirect };

// Counts the encoder returns, in this order (h264.py STAT_NAMES), then
// coverage: coeff_token (5 x 68), total_zeros (15 x 16 + 3 x 4), run_before
// (7 x 15), and the CABAC contexts' decisions (4 x 1024: the I slices'
// table, then cabac_init_idc 0-2's).
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
    kStatI8Mode,               // 9
    kStatT8Inter = kStatI8Mode + 9,
    kStatCavlc8x8,
    kStatCabacPcm,
    kStatB16x16,               // B_16x16, B 16x8, B 8x16, B_8x8, B_Direct_16x16, B_Skip
    kStatBSub = kStatB16x16 + 6,  // 13
    kStatPred = kStatBSub + 13,   // 3: a B partition's list 0, list 1, both
    kStatIntraInB = kStatPred + 3,
    kStatRefIdxL1Nonzero,
    kStatDirectColIntra,
    kStatDirectColList1,
    kStatDirectColZero,
    kStatDirectRefMapped,
    kNumStats,
};
const int kCoverToken = kNumStats, kCoverZeros = kCoverToken + 5 * 68,
          kCoverDcZeros = kCoverZeros + 15 * 16, kCoverRun = kCoverDcZeros + 3 * 4,
          kCoverCtx = kCoverRun + 7 * 15, kStatsTotal = kCoverCtx + 4 * 1024;

// The forward 8x8 integer transform's basis (8.5.13 inverted), rows.
const int kFwd8[8][8] = {
    {8, 8, 8, 8, 8, 8, 8, 8},         {12, 10, 6, 3, -3, -6, -10, -12},
    {8, 4, -4, -8, -8, -4, 4, 8},     {10, -3, -12, -6, 6, 12, 3, -10},
    {8, -8, -8, 8, 8, -8, -8, 8},     {6, -12, 3, 10, -10, -3, 12, -6},
    {4, -8, 8, -4, -4, 8, -8, 4},     {3, -6, 10, -12, 12, -10, 6, -3},
};
// Each row's squared norm.
const int kFwd8Norm[8] = {512, 578, 320, 578, 512, 578, 320, 578};

struct Encoder : Codec {
    Writer w;
    const uint8_t* const* src;
    const int32_t* plan;
    const int32_t* forced;
    int64_t* stats;
    int qp_prev;
    bool qp_delta_nonzero = false;
    Residual res;
    CabacSyntax<CabacEncoder> syn;

    Encoder(const Params& p, const uint8_t* const* refs_, const int32_t* ids,
            const MbState* colocated, uint8_t* const* out, MbState* s,
            const uint8_t* const* source, const int32_t* pl, const int32_t* lv, int64_t* st_)
        : Codec(p, refs_, ids, colocated, out, s), src(source), plan(pl), forced(lv), stats(st_),
          qp_prev(p.qp) {
        syn.k = this;
        syn.e.w = &w;
        syn.e.cover = stats + kCoverCtx + 1024 * (c.slice_type == 2 ? 0 : 1 + c.cabac_init_idc);
        direct_counts = stats + kStatDirectColIntra;
    }

    int run() {
        if (c.cabac) return run_cabac();
        int skip = 0;
        const int end = std::min(c.first_mb + c.mb_count, c.mbw * c.mbh);
        for (int a = c.first_mb; a < end; ++a) {
            const int32_t* pl = plan + int64_t(a) * kPlanInts;
            start_mb(a);
            if (c.slice_type != 2 && pl[0] == kPlanSkip) {
                const int status = encode_skip();
                if (status) return status;
                ++skip;
                continue;
            }
            if (c.slice_type != 2) {
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

    int run_cabac() {
        while (w.count) w.put(1, 1);  // cabac_alignment_one_bit
        init_contexts(syn.e.state, c.slice_type, c.cabac_init_idc, c.qp);
        syn.e.start();
        const int end = std::min(c.first_mb + c.mb_count, c.mbw * c.mbh);
        for (int a = c.first_mb; a < end; ++a) {
            const int32_t* pl = plan + int64_t(a) * kPlanInts;
            start_mb(a);
            const bool skip = c.slice_type != 2 && pl[0] == kPlanSkip;
            if (c.slice_type != 2) syn.skip(skip);
            const int status = skip ? encode_skip() : encode_mb(pl);
            if (status) return status;
            syn.e.terminate(a == end - 1);  // end_of_slice_flag
        }
        if (w.count) w.put(8 - w.count, 0);
        return kOk;
    }

    // P_Skip or B_Skip.
    int encode_skip() {
        MbPred m;
        if (c.slice_type == 1) {
            m = b_mb_pred(0);
            const int status = derive(m);
            if (status) return status;
            ++stats[kStatB16x16 + 5];
        } else {
            int ref[2] = {0, -1}, mv[2][2] = {{0, 0}, {0, 0}};
            skip_mv(&mv[0][0], &mv[0][1]);
            set_motion(0, 0, 16, 16, ref, mv);
            ++stats[kStatSkip];
        }
        cur->kind = kSkip;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(qp_prev);
        qp_delta_nonzero = false;
        predict_mb(m);
        count_outside(0, 0, 16, 16);
        return kOk;
    }

    // Counts a vector of the blocks of (x, y, w, h) that points outside the picture.
    void count_outside(int x, int y, int w_, int h) {
        const int b = (y >> 2) * 4 + (x >> 2);
        for (int l = 0; l < 2; ++l) {
            if (cur->ref_idx[l][b] < 0) continue;
            const int px = 16 * mbx + x + (cur->mv[l][b][0] >> 2);
            const int py = 16 * mby + y + (cur->mv[l][b][1] >> 2);
            if (px < 0 || py < 0 || px + w_ > 16 * c.mbw || py + h > 16 * c.mbh)
                ++stats[kStatMvOutside];
        }
    }

    void te(int l, int v) {
        if (num_ref(l) == 2)
            w.put(1, !v);
        else
            w.ue(v);
    }

    int encode_mb(const int32_t* pl) {
        int kind = pl[0];
        if (kind == kPlanI4Levels && !forced) return kErrArguments;
        if (c.slice_type == 2 && kind > kPlanPcm && kind != kPlanI4Levels) kind = kPlanI16;
        if (c.slice_type == 0 && kind == kPlanDirect) kind = kPlanP16;
        res.clear();
        const int target_qp = clip3(std::max(0, qp_prev - 26), std::min(51, qp_prev + 25), pl[3]);
        cur->qp = static_cast<int8_t>(target_qp);
        if (kind <= kPlanPcm || kind == kPlanI4Levels) {
            if (c.slice_type != 2) ++stats[c.slice_type == 0 ? kStatIntraInP : kStatIntraInB];
            if (kind == kPlanPcm) return encode_pcm();
            return encode_intra(kind, pl, target_qp);
        }
        return encode_inter(kind, pl, target_qp);
    }

    // The mb_type of an intra macroblock (0-25) in this slice.
    void write_intra_mb_type(int mb_type) {
        if (c.cabac) {
            if (c.slice_type == 0)
                syn.mb_type_p(5 + mb_type);
            else if (c.slice_type == 1)
                syn.mb_type_b(23 + mb_type);
            else
                syn.mb_type_i(mb_type, 3);
        } else {
            w.ue((c.slice_type == 0 ? 5 : (c.slice_type == 1 ? 23 : 0)) + mb_type);
        }
    }

    int encode_pcm() {
        write_intra_mb_type(25);
        if (w.count) w.put(8 - w.count, 0);  // pcm_alignment_zero_bit
        if (c.cabac) ++stats[kStatCabacPcm];
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
        if (c.cabac) syn.e.start();
        cur->kind = kIPCM;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(0);
        std::memset(cur->nnz, 16, 24);
        cur->cbf = ~0u;
        cur->nonzero = 0xFFFF;
        cur->cbp = 0x2F;
        qp_delta_nonzero = false;
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
    // dequantised value (times `gain`) stays in 16 bits; `weight` the
    // scaling list's entry (16: flat).
    static int bound(int level, int qp, int cls, int gain, int weight = 16) {
        const int scale = (((kDequant[qp % 6][cls] * weight) << (qp / 6)) >> 4) * gain;
        const int lim = std::min(2047, std::max(1, 32000 / std::max(1, scale)));
        return clip3(-lim, lim, level);
    }
    static int quant(int v, int qp, int cls, bool intra, int extra_shift = 0, int weight = 16) {
        const int qbits = 15 + qp / 6 + extra_shift;
        const int64_t f = (int64_t(1) << qbits) / (intra ? 3 : 6);
        const int64_t mult = (int64_t(kQuant[qp % 6][cls]) * 16 + weight / 2) / weight;
        const int64_t mag = (int64_t(std::abs(v)) * mult + f) >> qbits;
        return v < 0 ? -static_cast<int>(mag) : static_cast<int>(mag);
    }
    // Residual of the 4x4 block at p (prediction) against s, with the
    // scaling list `weights` (raster); levels raster.
    void block_levels(const uint8_t* s, int ss, const uint8_t* p, int ps, int qp, bool intra,
                      const int* weights, int32_t* levels, int* dc_coef) {
        int diff[16], coef[16];
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) diff[4 * i + j] = s[i * ss + j] - p[i * ps + j];
        fdct(diff, coef);
        for (int k = 0; k < 16; ++k)
            levels[k] = bound(quant(coef[k], qp, dq_class(k), intra, 0, weights[k]), qp,
                              dq_class(k), 1, weights[k]);
        if (dc_coef) {
            *dc_coef = coef[0];
            levels[0] = 0;
        }
    }
    // The same for an 8x8 block, in integers (so that every host writes the
    // same levels): level = 4096 * 64 * Y / (|row i|^2 |row j|^2
    // LevelScale8x8 2^(qP / 6)), Y the forward transform, rounded with the
    // intra or inter dead zone.
    void block_levels8(const uint8_t* s, int ss, const uint8_t* p, int ps, int qp, bool intra,
                       const int32_t* ls, int32_t* levels) {
        int64_t diff[64], t[64];
        for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 8; ++j) diff[8 * i + j] = s[i * ss + j] - p[i * ps + j];
        for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 8; ++j) {
                int64_t v = 0;
                for (int k = 0; k < 8; ++k) v += kFwd8[i][k] * diff[8 * k + j];
                t[8 * i + j] = v;
            }
        const int32_t* scale = ls + 64 * (qp % 6);
        const int dz = intra ? 3 : 6;
        for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 8; ++j) {
                int64_t y = 0;
                for (int k = 0; k < 8; ++k) y += t[8 * i + k] * kFwd8[j][k];
                const int64_t num = 262144 * std::abs(y);
                const int64_t den = (int64_t(kFwd8Norm[i]) * kFwd8Norm[j] * scale[8 * i + j]) << (qp / 6);
                const int64_t mag = (dz * num + den) / (dz * den);
                const int64_t lim = std::min<int64_t>(2047, std::max<int64_t>(1, 32000 * 64 / ((int64_t(scale[8 * i + j]) << (qp / 6)))));
                const int level = static_cast<int>(std::min(mag, lim));
                levels[8 * i + j] = y < 0 ? -level : level;
            }
    }

    static bool any(const int32_t* v, int n) {
        for (int k = 0; k < n; ++k)
            if (v[k]) return true;
        return false;
    }

    // -- conformance: a stream's inverse transforms stay in 16 bits ---------------------
    // (8.5.12.2, 8.5.13.2; FFmpeg keeps the intermediate values, and the
    // DC with its rounding, in 16 bits). A block whose levels would leave
    // them is scaled down until it does not.
    static bool fits16(int64_t v) { return v >= -32768 && v <= 32767; }
    // One 1-D inverse transform in place; false when a value, or the sum of
    // the magnitudes of the terms that make it (so any partial sum, in
    // whatever order an implementation adds), leaves 16 bits.
    static bool idct4_fits(int64_t* x, int s) {
        const int64_t x0 = x[0], x1 = x[s], x2 = x[2 * s], x3 = x[3 * s];
        const int64_t e = x0 + x2, f = x0 - x2, g = (x1 >> 1) - x3, h = x1 + (x3 >> 1);
        x[0] = e + h;
        x[s] = f + g;
        x[2 * s] = f - g;
        x[3 * s] = e - h;
        const int64_t m = std::abs(x0) + std::abs(x2) + std::abs(x1) + std::abs(x3);
        return fits16(m);
    }
    static bool idct8_fits(int64_t* x, int s) {
        int64_t m = 0;
        for (int k = 0; k < 8; ++k) m += std::abs(x[k * s]) + (std::abs(x[k * s]) >> 1);
        int d[8];
        for (int k = 0; k < 8; ++k) d[k] = static_cast<int>(x[k * s]);
        idct8_1d(d, 1);
        for (int k = 0; k < 8; ++k) x[k * s] = d[k];
        return fits16(m);
    }
    // Whether the 4x4 block of raster levels `coef` (DC `dc` as idct_add's),
    // or the 8x8 block, decodes within 16 bits.
    static bool conforms4(const int32_t* coef, int qp, const int32_t* ls, int32_t dc) {
        int64_t d[16];
        const int q6 = qp / 6;
        const int32_t* s = ls + 16 * (qp % 6);
        for (int p = 0; p < 16; ++p) {
            const int64_t v = int64_t(coef[p]) * s[p];
            d[p] = q6 >= 4 ? v * (1 << (q6 - 4)) : (v + (1 << (3 - q6))) >> (4 - q6);
            if (!fits16(d[p])) return false;
        }
        if (dc != INT32_MIN) d[0] = dc;
        if (!fits16(d[0] + 32)) return false;
        for (int i = 0; i < 4; ++i)
            if (!idct4_fits(d + 4 * i, 1)) return false;
        for (int j = 0; j < 4; ++j)
            if (!idct4_fits(d + j, 4)) return false;
        return true;
    }
    static bool conforms8(const int32_t* coef, int qp, const int32_t* ls) {
        int64_t d[64];
        const int q6 = qp / 6;
        const int32_t* s = ls + 64 * (qp % 6);
        for (int p = 0; p < 64; ++p) {
            const int64_t v = int64_t(coef[p]) * s[p];
            d[p] = q6 >= 6 ? v * (1 << (q6 - 6)) : (v + (1 << (5 - q6))) >> (6 - q6);
            if (!fits16(d[p])) return false;
        }
        if (!fits16(d[0] + 32)) return false;
        for (int i = 0; i < 8; ++i)
            if (!idct8_fits(d + 8 * i, 1)) return false;
        for (int j = 0; j < 8; ++j)
            if (!idct8_fits(d + j, 8)) return false;
        return true;
    }
    static void conform4(int32_t* coef, int qp, const int32_t* ls, int32_t dc) {
        while (!conforms4(coef, qp, ls, dc))
            for (int p = 0; p < 16; ++p) coef[p] = coef[p] * 7 / 8;
    }
    static void conform8(int32_t* coef, int qp, const int32_t* ls) {
        while (!conforms8(coef, qp, ls))
            for (int p = 0; p < 64; ++p) coef[p] = coef[p] * 7 / 8;
    }

    // Chroma residual of the prediction in the picture: levels into res; cbp chroma.
    int chroma_levels(int qp, bool intra) {
        int cbp = 0;
        for (int k = 0; k < 2; ++k) {
            const int qpc = chroma_qp(qp, c.cqp_offset[k]);
            const int* weights = c.w4[(intra ? 0 : 3) + 1 + k];
            int dcs[4];
            for (int b = 0; b < 4; ++b) {
                const int off = (8 * mby + 4 * (b >> 1)) * cs + 8 * mbx + 4 * (b & 1);
                block_levels(src[1 + k] + off, cs, pic[1 + k] + off, cs, qpc, intra, weights,
                             res.chroma_ac[k][b], &dcs[b]);
            }
            const int f[4] = {dcs[0] + dcs[1] + dcs[2] + dcs[3], dcs[0] - dcs[1] + dcs[2] - dcs[3],
                              dcs[0] + dcs[1] - dcs[2] - dcs[3], dcs[0] - dcs[1] - dcs[2] + dcs[3]};
            for (int b = 0; b < 4; ++b)
                res.chroma_dc[k][b] =
                    bound(quant(f[b], qpc, 0, intra, 1, weights[0]), qpc, 0, 2, weights[0]);
            const int32_t* ls = list4(1 + k, intra);
            int32_t dc[4];
            chroma_dc(res.chroma_dc[k], qpc, ls[16 * (qpc % 6)], dc);
            for (int b = 0; b < 4; ++b) conform4(res.chroma_ac[k][b], qpc, ls, dc[b]);
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
        if (c.cabac)
            syn.qp_delta(delta, qp_delta_nonzero);
        else
            w.se(delta);
        if (delta) ++stats[kStatQpDelta];
        qp_delta_nonzero = delta != 0;
        qp_prev = qp;
    }

    // The intra mode syntax of an I_NxN macroblock: the flag and the 16 4x4
    // or four 8x8 modes.
    void write_nxn_modes() {
        if (c.t8x8_mode) {
            if (c.cabac)
                syn.t8x8(cur->t8x8);
            else
                w.put(1, cur->t8x8);
        }
        for (int k = 0; k < (cur->t8x8 ? 4 : 16); ++k) {
            const int bx = cur->t8x8 ? 2 * (k & 1) : kBlkX[k];
            const int by = cur->t8x8 ? 2 * (k >> 1) : kBlkY[k];
            const int pred = pred_i4mode(bx, by), mode = cur->i4mode[by * 4 + bx];
            const int rem = mode == pred ? -1 : (mode < pred ? mode : mode - 1);
            if (c.cabac) {
                syn.pred_mode(rem);
            } else {
                w.put(1, rem < 0);
                if (rem >= 0) w.put(3, rem);
            }
            ++stats[(cur->t8x8 ? kStatI8Mode : kStatI4Mode) + mode];
        }
    }

    int encode_intra(int kind, const int32_t* pl, int qp) {
        static const int kChromaToI16[4] = {2, 1, 0, 3};
        cur->kind = kind == kPlanI16 ? kI16x16 : kI4x4;
        int chroma_mode = pl[2] & 3;
        if (!i16_mode_ok(kChromaToI16[chroma_mode], avail_a, avail_b, avail_d)) chroma_mode = 0;
        cur->chroma_mode = static_cast<int8_t>(chroma_mode);
        cur->t8x8 = static_cast<int8_t>(kind == kPlanI4 && c.t8x8_mode && pl[60]);
        int cbp_luma = 0, i16mode = 0;
        int32_t dc_levels[16] = {0};
        if (cur->t8x8) {
            for (int b8 = 0; b8 < 4; ++b8) {
                bool l, t, tr, tl;
                i8_avail(b8, &l, &t, &tr, &tl);
                int mode = pl[12 + 8 * (b8 >> 1) + 2 * (b8 & 1)] % 9;
                if (!i4_mode_ok(mode, l, t, tl)) mode = 2;
                for (int k = 0; k < 4; ++k)
                    cur->i4mode[(2 * (b8 >> 1) + (k >> 1)) * 4 + 2 * (b8 & 1) + (k & 1)] =
                        static_cast<int8_t>(mode);
                pred8x8(b8, mode);
                const int off = (16 * mby + 8 * (b8 >> 1)) * ys + 16 * mbx + 8 * (b8 & 1);
                block_levels8(src[0] + off, ys, pic[0] + off, ys, qp, true, list8(true),
                              res.luma8[b8]);
                conform8(res.luma8[b8], qp, list8(true));
                if (any(res.luma8[b8], 64)) {
                    cbp_luma |= 1 << b8;
                    idct8_add(pic[0] + off, ys, res.luma8[b8], qp, list8(true));
                }
            }
        } else if (cur->kind == kI4x4) {
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
                    block_levels(src[0] + off, ys, pic[0] + off, ys, qp, true, c.w4[0],
                                 res.luma[b], nullptr);
                    conform4(res.luma[b], qp, list4(0, true), INT32_MIN);
                }
                if (any(res.luma[b], 16)) {
                    cbp_luma |= 1 << (k >> 2);
                    idct_add(pic[0] + off, ys, res.luma[b], qp, list4(0, true), INT32_MIN);
                }
            }
        } else {
            i16mode = pl[1] & 3;
            if (!i16_mode_ok(i16mode, avail_a, avail_b, avail_d)) i16mode = 2;
            pred16x16(i16mode);
            int dcs[16];
            for (int b = 0; b < 16; ++b) {
                const int off = (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3);
                block_levels(src[0] + off, ys, pic[0] + off, ys, qp, true, c.w4[0], res.luma[b],
                             &dcs[b]);
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
                dc_levels[p] = bound(quant(f[p], qp, 0, true, 1, c.w4[0][0]), qp, 0, 4, c.w4[0][0]);
            std::memcpy(res.luma_dc, dc_levels, sizeof(dc_levels));
            const int32_t* ls = list4(0, true);
            int32_t dc[16];
            luma_dc(res.luma_dc, qp, ls[16 * (qp % 6)], dc);
            cbp_luma = 0;
            for (int b = 0; b < 16; ++b) {
                conform4(res.luma[b], qp, ls, dc[b]);
                if (any(res.luma[b], 16)) cbp_luma = 15;
            }
            if (!cbp_luma)
                for (int b = 0; b < 16; ++b) std::memset(res.luma[b], 0, sizeof(res.luma[b]));
        }
        pred_chroma(chroma_mode);
        const int cbp_chroma = chroma_levels(qp, true);
        const int cbp = cbp_chroma << 4 | cbp_luma;
        // Syntax.
        const int i16_type = 1 + i16mode + 4 * cbp_chroma + (cbp_luma ? 12 : 0);
        const int mb_type = cur->kind == kI4x4 ? 0 : i16_type;
        write_intra_mb_type(mb_type);
        if (cur->kind == kI4x4)
            write_nxn_modes();
        else
            ++stats[kStatI16Mode + i16mode];
        if (c.cabac)
            syn.chroma_mode(chroma_mode);
        else
            w.ue(chroma_mode);
        ++stats[kStatChromaMode + chroma_mode];
        if (cur->kind == kI4x4) {
            if (c.cabac)
                syn.cbp(cbp);
            else
                w.ue(tables().intra_cbp_code[cbp]);
        }
        cur->cbp = static_cast<uint8_t>(cbp);
        const bool coded = cbp || cur->kind == kI16x16;
        if (coded)
            write_qp(qp);
        else
            qp_delta_nonzero = false;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(qp_prev);
        write_residual(cbp);
        // Reconstruct what is not yet: the Intra16x16 luma and the chroma.
        if (cur->kind == kI16x16) {
            int32_t dc[16];
            const int32_t* ls = list4(0, true);
            luma_dc(res.luma_dc, qp, ls[16 * (qp % 6)], dc);
            for (int b = 0; b < 16; ++b)
                idct_add(pic[0] + (16 * mby + 4 * (b >> 2)) * ys + 16 * mbx + 4 * (b & 3), ys,
                         res.luma[b], qp, ls, dc[b]);
        }
        add_chroma_residual(res, cbp_chroma);
        if (cbp_chroma == 2) ++stats[kStatCbpChromaAc];
        return kOk;
    }

    int encode_inter(int kind, const int32_t* pl, int qp) {
        cur->kind = kInter;
        const bool b_slice = c.slice_type == 1;
        MbPred m;
        if (kind == kPlanDirect) {
            m = b_mb_pred(0);
        } else if (kind <= kPlanP8x16) {
            m.shape = kind - kPlanP16;
            for (int k = 0; k < m.groups(); ++k)
                m.mode[k] = b_slice ? clip3(1, 3, pl[61 + k]) : 1;
        } else {
            m.shape = 3;
            for (int k = 0; k < 4; ++k) {
                if (b_slice)
                    b_sub(&m, k, std::abs(pl[4 + k]) % 13);
                else
                    m.sub[k] = pl[4 + k] & 3;
            }
            // CABAC has no P_8x8ref0: it writes P_8x8 with its zero references.
            m.ref0 = kind == kPlanP8x8Ref0 && !c.cabac && !b_slice;
        }
        int target[2][16][2];
        Rect parts[16];
        const int n = pred_rects(m, parts);
        for (int l = 0; l < 2; ++l) {
            for (int g = 0; g < m.groups(); ++g) {
                int x, y;
                group_origin(m.shape, g, &x, &y);
                const int b8 = (y >> 3) * 2 + (x >> 3);
                m.ref[l][g] = kind == kPlanP8x8Ref0 && !b_slice ? 0
                              : std::min(std::max(0, pl[(l ? 64 : 8) + b8]), num_ref(l) - 1);
                if (m.ref[l][g] < 0) m.ref[l][g] = 0;
            }
            for (int i = 0; i < n; ++i) {
                const int b = (parts[i].y >> 2) * 4 + (parts[i].x >> 2);
                const int32_t* mv = pl + (l ? 68 : 28) + 2 * b;
                target[l][i][0] = clip3(-8192, 8191, mv[0]);
                target[l][i][1] = clip3(-2048, 2047, mv[1]);
            }
        }
        const int status = derive(m, target);
        if (status) return status;
        predict_mb(m);
        for (int i = 0; i < n; ++i) {
            const Rect& p = parts[i];
            count_outside(p.x, p.y, p.w, p.h);
            if (!m.mode[p.group]) continue;
            if ((m.mode[p.group] & 1) && m.ref[0][p.group]) ++stats[kStatRefIdxNonzero];
            if ((m.mode[p.group] & 2) && m.ref[1][p.group]) ++stats[kStatRefIdxL1Nonzero];
            if (b_slice) ++stats[kStatPred + m.mode[p.group] - 1];
        }
        if (b_slice) {
            ++stats[kStatB16x16 + (m.direct16 ? 4 : m.shape)];
            if (m.shape == 3 && !m.direct16)
                for (int k = 0; k < 4; ++k) ++stats[kStatBSub + b_sub_type(m, k)];
        } else if (m.shape < 3) {
            ++stats[kStatP16x16 + m.shape];
        } else {
            for (int k = 0; k < 4; ++k) ++stats[kStatSub + m.sub[k]];
            ++stats[m.ref0 ? kStatP8x8Ref0 : kStatP8x8];
        }
        const bool no_small = no_sub8x8(m);
        bool t8 = c.t8x8_mode && no_small && pl[60];
        int cbp_luma = 0;
        for (int b8 = 0; b8 < 4; ++b8) {
            if (t8) {
                const int off = (16 * mby + 8 * (b8 >> 1)) * ys + 16 * mbx + 8 * (b8 & 1);
                block_levels8(src[0] + off, ys, pic[0] + off, ys, qp, false, list8(false),
                              res.luma8[b8]);
                conform8(res.luma8[b8], qp, list8(false));
                if (any(res.luma8[b8], 64)) cbp_luma |= 1 << b8;
                continue;
            }
            for (int k = 4 * b8; k < 4 * b8 + 4; ++k) {
                const int b = kBlkY[k] * 4 + kBlkX[k];
                const int off = (16 * mby + 4 * kBlkY[k]) * ys + 16 * mbx + 4 * kBlkX[k];
                block_levels(src[0] + off, ys, pic[0] + off, ys, qp, false, c.w4[3], res.luma[b],
                             nullptr);
                conform4(res.luma[b], qp, list4(0, false), INT32_MIN);
                if (any(res.luma[b], 16)) cbp_luma |= 1 << b8;
            }
        }
        for (int k = 0; k < 16; ++k)
            if (!(cbp_luma >> (k >> 2) & 1)) std::memset(res.luma[kBlkY[k] * 4 + kBlkX[k]], 0, 64);
        for (int b8 = 0; b8 < 4; ++b8)
            if (!(cbp_luma >> b8 & 1)) std::memset(res.luma8[b8], 0, sizeof(res.luma8[b8]));
        t8 = t8 && cbp_luma;
        cur->t8x8 = static_cast<int8_t>(t8);
        if (t8) ++stats[kStatT8Inter];
        const int cbp_chroma = chroma_levels(qp, false);
        const int cbp = cbp_chroma << 4 | cbp_luma;
        // Syntax: mb_type, sub_mb_types, each list's ref_idx, each list's mvds.
        if (c.cabac) {
            if (b_slice)
                syn.mb_type_b(b_mb_type(m));
            else
                syn.mb_type_p(m.shape);
            if (m.shape == 3 && !m.direct16)
                for (int k = 0; k < 4; ++k) {
                    if (b_slice)
                        syn.sub_mb_type_b(b_sub_type(m, k));
                    else
                        syn.sub_mb_type(m.sub[k]);
                }
            for (int l = 0; l < 2; ++l)
                for (int g = 0; g < m.groups(); ++g) {
                    if (!(m.mode[g] >> l & 1)) continue;
                    if (num_ref(l) > 1) {
                        int x, y;
                        group_origin(m.shape, g, &x, &y);
                        syn.ref_idx(m.ref[l][g], ref_idx_inc(l, x, y), num_ref(l) - 1);
                    }
                    for (int b8 = 0; b8 < 4; ++b8)
                        if (group_blocks(m.shape, g) >> b8 & 1) ref8[l][b8] = static_cast<int8_t>(m.ref[l][g]);
                }
            for (int l = 0; l < 2; ++l)
                for (int i = 0; i < n; ++i) {
                    const Rect& p = parts[i];
                    if (!(m.mode[p.group] >> l & 1)) continue;
                    syn.mvd(m.mvd[l][i][0], 0, mvd_inc(l, p.x, p.y, 0));
                    syn.mvd(m.mvd[l][i][1], 1, mvd_inc(l, p.x, p.y, 1));
                    set_mvd(l, p, m.mvd[l][i][0], m.mvd[l][i][1]);
                }
            syn.cbp(cbp);
            if ((cbp & 15) && c.t8x8_mode && no_small) syn.t8x8(t8);
        } else {
            w.ue(b_slice ? b_mb_type(m) : (m.ref0 ? 4 : m.shape));
            if (m.shape == 3 && !m.direct16)
                for (int k = 0; k < 4; ++k) w.ue(b_slice ? b_sub_type(m, k) : m.sub[k]);
            for (int l = 0; l < 2; ++l)
                for (int g = 0; g < m.groups(); ++g)
                    if ((m.mode[g] >> l & 1) && num_ref(l) > 1 && !m.ref0) te(l, m.ref[l][g]);
            for (int l = 0; l < 2; ++l)
                for (int i = 0; i < n; ++i) {
                    if (!(m.mode[parts[i].group] >> l & 1)) continue;
                    w.se(m.mvd[l][i][0]);
                    w.se(m.mvd[l][i][1]);
                }
            w.ue(tables().inter_cbp_code[cbp]);
            if ((cbp & 15) && c.t8x8_mode && no_small) w.put(1, t8);
        }
        cur->cbp = static_cast<uint8_t>(cbp);
        if (cbp)
            write_qp(qp);
        else
            qp_delta_nonzero = false;
        cur->qp = static_cast<int8_t>(qp_prev);
        set_lf_qp(qp_prev);
        write_residual(cbp);
        add_inter_luma_residual(res, cbp);
        add_chroma_residual(res, cbp_chroma);
        if (cbp_chroma == 2) ++stats[kStatCbpChromaAc];
        return kOk;
    }

    void write_residual(int cbp) {
        if (c.cabac) return write_residual_cabac(cbp);
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
            } else if (cur->t8x8) {
                for (int i = 0; i < 16; ++i) levels[i] = res.luma8[k >> 2][kZigzag8x8[4 * i + (k & 3)]];
                total = write_block(luma_nc(bx, by), 16, levels);
                if ((k & 3) == 0) ++stats[kStatCavlc8x8];
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

    void write_residual_cabac(int cbp) {
        int32_t lv[64];
        if (cur->kind == kI16x16) {
            for (int i = 0; i < 16; ++i) lv[i] = res.luma_dc[kZigzag[i]];
            if (syn.block(0, cbf_dc_inc(16), lv, 16)) cur->cbf |= 1u << 16;
        }
        for (int b8 = 0; b8 < 4; ++b8) {
            if (!(cbp >> b8 & 1)) continue;
            if (cur->t8x8) {
                for (int i = 0; i < 64; ++i) lv[i] = res.luma8[b8][kZigzag8x8[i]];
                syn.block(5, 0, lv, 64);
                cur->cbf |= mask8(b8);
                continue;
            }
            for (int k = 4 * b8; k < 4 * b8 + 4; ++k) {
                const int bx = kBlkX[k], by = kBlkY[k], b = by * 4 + bx;
                const bool i16 = cur->kind == kI16x16;
                for (int i = 0; i < (i16 ? 15 : 16); ++i) lv[i] = res.luma[b][kZigzag[i + i16]];
                if (syn.block(i16 ? 1 : 2, cbf_luma_inc(bx, by), lv, i16 ? 15 : 16))
                    cur->cbf |= 1u << b;
            }
        }
        if (cbp >> 4)
            for (int k = 0; k < 2; ++k)
                if (syn.block(3, cbf_dc_inc(17 + k), res.chroma_dc[k], 4)) cur->cbf |= 1u << (17 + k);
        if (cbp >> 4 == 2)
            for (int k = 0; k < 2; ++k)
                for (int b = 0; b < 4; ++b) {
                    for (int i = 0; i < 15; ++i) lv[i] = res.chroma_ac[k][b][kZigzag[i + 1]];
                    if (syn.block(4, cbf_chroma_ac_inc(k, b & 1, b >> 1), lv, 15))
                        cur->cbf |= 1u << (19 + 4 * k + b);
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

// The count of int32 a slice's parameters take (params[] below).
extern "C" int hive_h264_param_ints() { return kParamInts; }

// Decode one slice's macroblocks.
//
// data, size: the slice NAL unit's RBSP (emulation prevention removed);
// bit_pos: the first bit after the slice header.
// params: Params' fields in order (make_params): width and height in
//   macroblocks, the slice's number in the picture (1 up),
//   first_mb_in_slice, slice type (0 P, 1 B, 2 I), SliceQP_Y,
//   num_ref_idx_l0_active, ..., the scaling lists, then B slices' and
//   weighted prediction's fields.
// refs: Y, U, V of each entry of RefPicList0, then of RefPicList1, at the
//   coded size (null: no picture there); ref_ids: an id per entry naming
//   its picture.
// colocated: the MbState array of RefPicList1[0] (B slices; else null).
// out: the picture's Y, U, V at the coded size; state: its MbState array.
// error_pos: the bit where decoding stopped.
// Returns 0, or a negative status (Status above).
extern "C" int hive_h264_decode_slice(const uint8_t* data, int64_t size, int64_t bit_pos,
                                      const int32_t* params, const uint8_t* const* refs,
                                      const int32_t* ref_ids, const uint8_t* colocated,
                                      uint8_t* const* out, uint8_t* state, int64_t* error_pos) {
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
    Decoder d(c, refs, ref_ids, reinterpret_cast<const MbState*>(colocated), out,
              reinterpret_cast<MbState*>(state), r);
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
// source: the picture's Y, U, V at the coded size. refs, ref_ids,
// colocated: as the decoder's. recon: the picture as the decoder rebuilds it before
// deblocking; state: its MbState array. plan: kPlanInts int32 a macroblock
// of the picture (see kPlanInts).
// levels: null, or 256 int32 a macroblock for plan kind 9 (see kPlanI4Levels).
// stats: kStatsTotal counts, added to.
// Returns the byte count, or a negative status; -capacity-1 when out is too
// small.
extern "C" int64_t hive_h264_encode_slice(const int32_t* params, const uint8_t* const* source,
                                          const uint8_t* const* refs, const int32_t* ref_ids,
                                          const uint8_t* colocated, uint8_t* const* recon,
                                          uint8_t* state,
                                          const int32_t* plan, const int32_t* levels,
                                          const uint8_t* prefix,
                                          int64_t prefix_bits, uint8_t* out, int64_t capacity,
                                          int64_t* stats) {
    const Params c = make_params(params);
    if (!valid(c) || c.mb_count < 1) return kErrArguments;
    for (int k = 0; k < c.num_ref + c.num_ref1; ++k)
        if (c.slice_type != 2 && !refs[3 * k]) return kErrMissing;
    if (c.slice_type == 1 && !colocated) return kErrMissing;
    Encoder e(c, refs, ref_ids, reinterpret_cast<const MbState*>(colocated), recon,
              reinterpret_cast<MbState*>(state), source, plan, levels, stats);
    for (int64_t i = 0; i < prefix_bits; ++i) e.w.put(1, (prefix[i >> 3] >> (7 - (i & 7))) & 1);
    const int status = e.run();
    if (status < 0) return status;
    const int64_t n = static_cast<int64_t>(e.w.bytes.size());
    if (n > capacity) return -capacity - 1;
    std::memcpy(out, e.w.bytes.data(), n);
    return n;
}
