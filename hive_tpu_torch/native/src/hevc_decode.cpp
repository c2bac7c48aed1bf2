// HEVC (ITU-T H.265 | ISO/IEC 23008-2) Main profile I, P and B pictures,
// both ways: one picture's slice segments decoded below their headers as the
// standard specifies (and so as FFmpeg's hevc decoder, and cv2.VideoCapture,
// decode them), its deblocking and sample adaptive offset, and the matching
// encode, which writes the test fixtures.
//
// The Python side (hive_tpu_torch/video/hevc.py) parses the parameter sets
// and slice segment headers, refuses what this file does not decode
// (scaling lists, tiles, WPP, dependent slice
// segments, depths above 8 bits, chroma other than 4:2:0), keeps the decoded
// picture buffer and builds each slice's reference picture lists, and hands
// hive_hevc_decode_picture each slice's RBSP from the byte after its header,
// the reference pictures' planes and the collocated picture's motion field.
// Per coding tree unit: sao() with its merges; the coding quadtree
// (split_cu_flag's context from the neighbours' depths); each coding unit's
// cu_transquant_bypass_flag, cu_skip_flag, pred_mode_flag and part_mode
// (2Nx2N / NxN intra; 2NxN, Nx2N, NxN and the four AMP parts inter). Intra:
// pcm_flag and its samples, the luma modes by their most probable mode list
// (8.4.2; an inter neighbour counts as DC) and the chroma mode (mode 4: the
// luma mode; a mode equal to the luma one becomes 34). Inter (8.5.3): each
// prediction unit's merge_idx (the spatial candidates with the parallel
// merge level and singleMCLFlag, the temporal one, the combined
// bi-predictive and zero ones; 8x4 / 4x8 bi-prediction cut to list 0) or its
// inter_pred_idc, ref_idx, mvd and mvp flag (AMVP: the spatial candidates,
// scaled by POC distance where they name another picture, then the temporal
// one from the collocated picture's 16x16 field, with its long-term rules),
// its samples interpolated (8-tap luma, 4-tap chroma, 14-bit intermediates,
// reference samples clamped to the picture) and weighted (default or
// explicit), then rqt_root_cbf. The transform tree (split_transform_flag
// with interSplitFlag and each prediction mode's depth, cbf_cb / cbf_cr /
// cbf_luma, inferred at an inter tree's root, the 4x4 luma blocks' chroma
// coded with the fourth), cu_qp_delta with the quantisation group's
// prediction (8.6.1), and residual_coding (9.3.4.2): the last position, coded
// sub-blocks, the diagonal, horizontal and vertical scans (by intra mode for
// 4x4 blocks and 8x8 luma), sig_coeff_flag, greater1 / greater2 with their
// context sets, sign data hiding, coeff_abs_level_remaining with its Rice
// parameter, transform_skip_flag. Reconstruction: flat dequantisation and
// the chroma QP table, the 4x4 DST of intra luma, the DCT from 4 to 32
// (clipped to 16 bits between its stages), transform skip and transquant
// bypass; intra sample prediction (8.4.4.2): reference sample availability
// in z-scan order and by slice, substitution, the [1 2 1] filter and strong
// intra smoothing, planar, DC, the 33 angles with the inverse-angle
// projection, the DC / horizontal / vertical edge filters of luma below
// 32x32. The contexts of P and B slices take initType 1 or 2 as
// cabac_init_flag swaps them. Then the picture's deblocking (8.7.2:
// transform, coding and prediction block edges on the 8x8 grid; bS 2 by an
// intra block, 1 by a luma block with coefficients, different references or
// vectors 4 quarter samples apart; the strong and normal luma filters,
// chroma at bS 2 on its 8x8 grid, each slice's disable flag, offsets and
// slice_loop_filter_across_slices_enabled_flag, PCM with
// pcm_loop_filter_disabled_flag and transquant bypass left alone) and SAO
// (8.7.3: band offset and the four edge classes on the deblocked picture),
// both run CTB by CTB in the order of FFmpeg's decoder, whose departures
// from the standard cv2's frames carry (LoopFilter).
//
// The encoder (hive_hevc_encode_picture) codes the same syntax through the
// same functions with cabac::Encoder: a plan decides each choice (seeded
// choices of every path above, or for a real picture the best intra mode
// and the merge candidate or searched vector nearest the target),
// quantises the true difference to the target and reconstructs exactly as
// the decoder does. It counts each path it writes and each context it
// codes. This is host code, not a device kernel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "cabac.h"
#include "hevc_tables.h"

namespace {

using namespace hevc;

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline int clip1(int v) { return clip3(0, 255, v); }
inline int sign(int v) { return (v > 0) - (v < 0); }

// ---------------------------------------------------------------------------
// Bit I/O.
// ---------------------------------------------------------------------------

// Zero bytes the caller leaves after each slice's RBSP, so that the
// reader's 8-byte window never reads past the buffer.
const int kPadding = 16;

struct Reader {
    const uint8_t* data;
    int64_t size_bits, pos;

    uint32_t get(int n) {
        if (!n) return 0;
        uint64_t w;
        std::memcpy(&w, data + (pos >> 3), 8);
        const uint32_t v = static_cast<uint32_t>((__builtin_bswap64(w) << (pos & 7)) >> (64 - n));
        pos += n;
        return v;
    }
};

struct Writer {
    std::vector<uint8_t> bytes;
    uint64_t acc = 0;
    int count = 0;

    void put(int n, uint32_t v) {
        if (!n) return;
        if (n > 24) {
            put(n - 16, v >> 16);
            put(16, v & 0xFFFF);
            return;
        }
        acc = (acc << n) | (v & ((uint64_t(1) << n) - 1));
        count += n;
        while (count >= 8) {
            count -= 8;
            bytes.push_back(static_cast<uint8_t>(acc >> count));
        }
        acc &= (uint64_t(1) << count) - 1;
    }
    void align_zero() {
        if (count) put(8 - count, 0);
    }
};

// ---------------------------------------------------------------------------
// Parameters (hevc.py's _params and _slice_params).
// ---------------------------------------------------------------------------

enum Param {
    kWidth, kHeight, kCtbLog2, kMinCbLog2, kMinTbLog2, kMaxTbLog2, kMaxDepthIntra,
    kPcmEnabled, kPcmBitsY, kPcmBitsC, kPcmMinLog2, kPcmMaxLog2, kPcmNoFilter,
    kSaoEnabled, kStrongSmoothing, kSignHiding, kTransformSkip, kQpDeltaEnabled,
    kQpDeltaDepth, kCbOffset, kCrOffset, kBypassEnabled,
    kMaxDepthInter, kAmpEnabled, kParMrgLevel, kPoc, kParamInts
};

// Each slice's parameters: the I slice's, then what P and B slices add and,
// for each list and each of its kMaxRefs entries, kRefInts (RefEntry).
const int kMaxRefs = 16, kRefInts = 9;
enum SliceParam {
    kSliceAddr, kSliceQp, kSaoLuma, kSaoChroma, kSliceCbOffset, kSliceCrOffset, kDeblockOff,
    kBetaDiv2, kTcDiv2, kAcross, kSliceCtbs,
    kSliceType, kNumRefL0, kNumRefL1, kMvdL1Zero, kInitType, kTmvp, kColFromL0, kColRefIdx,
    kMaxMerge, kWeighted, kLumaDenom, kChromaDenom, kSliceRefs,
    kSliceInts = kSliceRefs + 2 * kMaxRefs * kRefInts
};
enum SliceType { kSliceB = 0, kSliceP = 1, kSliceI = 2 };

// The motion field a picture leaves for the temporal candidates of later
// ones (8.5.3.2.8): one record of kColInts per 16x16 block, its top-left
// 4x4 block's prediction flags (0: intra), the two vectors, the POC of each
// list's reference picture and whether it was a long-term reference.
enum ColField { kColFlags, kColMv0x, kColMv0y, kColMv1x, kColMv1y, kColPoc0, kColPoc1, kColLt0,
                kColLt1, kColInts };

// PartMode (Table 7-10).
enum Part { kPart2Nx2N, kPart2NxN, kPartNx2N, kPartNxN, kPart2NxnU, kPart2NxnD, kPartnLx2N,
            kPartnRx2N };

enum Status {
    kOk = 0,
    kErrArgs = -1,
    kErrOverrun = -2,
    kErrPastEnd = -3,
    kErrQpDelta = -4,
    kErrCoefficient = -5,
    kErrCapacity = -6,
    kErrShort = -7,
};

// One entry of a reference picture list: the picture's slot among the
// reference planes passed in, its POC, whether it is a long-term reference,
// and its explicit weights and offsets (luma, Cb, Cr; 8.5.3.3.4.3).
struct RefEntry {
    int slot, poc, lt, w[3], o[3];
};

struct Slice {
    int addr, qp, sao_luma, sao_chroma, cb_offset, cr_offset, deblock_off, beta, tc, across;
    int ctbs;   // the encoder's count of CTUs; the decoder reads end_of_slice_segment_flag
    int type, nref[2], mvd_l1_zero, init_type, tmvp, col_from_l0, col_ref, max_merge, weighted;
    int denom[2];                     // luma_log2_weight_denom, ChromaLog2WeightDenom
    bool no_backward;                 // NoBackwardPredFlag (8.5.3.2.9)
    RefEntry ref[2][kMaxRefs];
};

// What the encoder counts (hevc.py's STAT_NAMES), then each context's
// decisions.
enum Stat {
    kStatLumaMode = 0,          // [log2 - 2][mode]: 4 x 35
    kStatChromaMode = 140,      // intra_chroma_pred_mode 0-4
    kStatChroma34 = 145,        // a chroma mode that became 34
    kStatNxN = 146,
    kStatPcm,
    kStatBypass,
    kStatTransformSkip,
    kStatSignHidden,
    kStatQpDelta,
    kStatQpDeltaSuffix,
    kStatDst,
    kStatDct4, kStatDct8, kStatDct16, kStatDct32,
    kStatScanHor, kStatScanVer,
    kStatStrongSmoothing,
    kStatFiltered,
    kStatMpm,
    kStatRemMode,
    kStatSaoBand, kStatSaoEdge0, kStatSaoEdge1, kStatSaoEdge2, kStatSaoEdge3,
    kStatSaoMergeLeft, kStatSaoMergeUp,
    kStatEscape,
    kStatRice4,
    kStatCsbfZero,
    kStatChromaTb4At3,
    kStatCuQpPred,
    // P and B slices.
    kStatSkip, kStatIntraInInter,
    kStatPart2NxN, kStatPartNx2N, kStatPartNxN, kStatPart2NxnU, kStatPart2NxnD, kStatPartnLx2N,
    kStatPartnRx2N,
    kStatMergeIdx, kStatAmvp = kStatMergeIdx + 5, kStatPredL0, kStatPredL1, kStatPredBi,
    kStatBiTo8x4, kStatMvp1, kStatMvdL1Zero, kStatRefIdx1, kStatRefIdxBypass, kStatMvdEscape,
    kStatMergeTemporal, kStatMergeCombined, kStatMergeZero, kStatAmvpTemporal, kStatTmvpScaled,
    kStatAmvpScaled, kStatWeightedUni, kStatWeightedBi, kStatRootCbf0, kStatInterSplit,
    kStatCbfLumaInferred, kStatMcFracBoth, kStatMcOutside, kStatSingleMcl, kStatMerExcluded,
    kStatInterBypass,
    kStatNamed,
    // Each context's decisions under each initType.
    kStatContexts = kStatNamed,
    kStatTotal = kStatNamed + 3 * kNumContexts,
};

// What the decoder's loop filters count.
enum FilterStat {
    kLfStrong, kLfNormal, kLfNormalP1, kLfNoChange, kLfChroma, kLfSkippedEdge, kLfSkippedPcm,
    kSaoBand, kSaoEdge, kSaoBlockedSlice, kSaoPicEdge, kSaoSkippedPcm, kLfStats
};

// ---------------------------------------------------------------------------
// The picture: planes and the state of each 4x4 block and CTB.
// ---------------------------------------------------------------------------

enum BlockFlag : uint8_t { kFlagPcm = 1, kFlagNoFilter = 2, kFlagEdgeV = 4, kFlagEdgeH = 8 };

struct SaoParams {
    int8_t type[3];        // 0 off, 1 band, 2 edge
    int8_t eo_class[3];
    int8_t band[3];        // sao_band_position
    int8_t offset[3][5];   // SaoOffsetVal
};

// A prediction unit's motion (8.5.3): the vectors (quarter luma samples)
// and reference indices of lists 0 and 1, and its prediction flags (bit l:
// list l used; 0: an intra block).
struct Mv {
    int x = 0, y = 0;
    bool operator==(const Mv& o) const { return x == o.x && y == o.y; }
    bool operator!=(const Mv& o) const { return !(*this == o); }
};

struct Mvf {
    Mv mv[2];
    int8_t ref[2] = {0, 0};
    uint8_t pf = 0;
};

// The same motion vectors and reference indices (of the lists used).
inline bool same_motion(const Mvf& a, const Mvf& b) {
    if (a.pf != b.pf) return false;
    for (int l = 0; l < 2; ++l)
        if ((a.pf >> l & 1) && (a.mv[l] != b.mv[l] || a.ref[l] != b.ref[l])) return false;
    return true;
}

// A vector of 16 bits, as uLX wraps it (8.5.3.2.1).
inline int wrap16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }

// The scaling of a vector by the ratio of two POC distances (8-179 to 8-183).
inline Mv scale_mv(Mv mv, int td, int tb) {
    td = clip3(-128, 127, td);
    tb = clip3(-128, 127, tb);
    const int tx = (16384 + std::abs(td) / 2) / td;
    const int f = clip3(-4096, 4095, (tb * tx + 32) >> 6);
    auto one = [&](int v) {
        const int p = f * v;
        return clip3(-32768, 32767, sign(p) * ((std::abs(p) + 127) >> 8));
    };
    return Mv{one(mv.x), one(mv.y)};
}

struct Picture {
    int w, h, ctb_log2, ctbs_w, ctbs_h, w4, h4;
    uint8_t* plane[3];
    int stride[3];
    std::vector<uint8_t> ipm, depth, flags, skip, cbf;
    std::vector<Mvf> mvf;
    std::vector<int8_t> qp;
    std::vector<uint32_t> zs;          // z-scan order of each 4x4 block
    std::vector<int> slice_of;         // slice index of each CTB (-1: not decoded)
    std::vector<SaoParams> sao;

    Picture(const int32_t* p, uint8_t* const* planes)
        : w(p[kWidth]), h(p[kHeight]), ctb_log2(p[kCtbLog2]) {
        const int ctb = 1 << ctb_log2;
        ctbs_w = (w + ctb - 1) >> ctb_log2;
        ctbs_h = (h + ctb - 1) >> ctb_log2;
        w4 = ctbs_w << (ctb_log2 - 2);
        h4 = ctbs_h << (ctb_log2 - 2);
        for (int c = 0; c < 3; ++c) {
            plane[c] = planes[c];
            stride[c] = c ? w / 2 : w;
        }
        ipm.assign(w4 * h4, 1);
        depth.assign(w4 * h4, 0);
        flags.assign(w4 * h4, 0);
        skip.assign(w4 * h4, 0);
        cbf.assign(w4 * h4, 0);
        mvf.assign(w4 * h4, Mvf{});
        qp.assign(w4 * h4, 0);
        zs.resize(w4 * h4);
        const int per = ctb_log2 - 2;
        for (int y = 0; y < h4; ++y)
            for (int x = 0; x < w4; ++x) {
                uint32_t z = static_cast<uint32_t>((y >> per) * ctbs_w + (x >> per)) << (2 * per);
                for (int i = 0; i < per; ++i)
                    z += ((x >> i & 1) << (2 * i)) + ((y >> i & 1) << (2 * i + 1));
                zs[y * w4 + x] = z;
            }
        slice_of.assign(ctbs_w * ctbs_h, -1);
        sao.assign(ctbs_w * ctbs_h, SaoParams{});
    }
    int at4(int x, int y) const { return (y >> 2) * w4 + (x >> 2); }
    int ctb_at(int x, int y) const { return (y >> ctb_log2) * ctbs_w + (x >> ctb_log2); }
    // 6.4.1: (xNb, yNb) is available to the block at (xCur, yCur) (luma).
    bool available(int xc, int yc, int xn, int yn) const {
        if (xn < 0 || yn < 0 || xn >= w || yn >= h) return false;
        if (zs[at4(xn, yn)] > zs[at4(xc, yc)]) return false;
        return slice_of[ctb_at(xn, yn)] == slice_of[ctb_at(xc, yc)];
    }
    template <class T>
    void fill4(std::vector<T>& a, int x0, int y0, int size, T v) { fill4(a, x0, y0, size, size, v); }
    template <class T>
    void fill4(std::vector<T>& a, int x0, int y0, int width, int height, T v) {
        const int nw = std::max(1, width >> 2), nh = std::max(1, height >> 2);
        for (int j = 0; j < nh && (y0 >> 2) + j < h4; ++j)
            for (int i = 0; i < nw && (x0 >> 2) + i < w4; ++i) a[at4(x0, y0) + j * w4 + i] = v;
    }
    void mark_edges(int x0, int y0, int size) {
        const int n = std::max(1, size >> 2);
        for (int j = 0; j < n; ++j) flags[at4(x0, y0) + j * w4] |= kFlagEdgeV;
        for (int i = 0; i < n; ++i) flags[at4(x0, y0) + i] |= kFlagEdgeH;
    }
};

// The scans (6.5.3 - 6.5.5): [log2 size 0-3][scanIdx][position] -> (x, y)
// packed as x | y << 4.
struct Scans {
    uint8_t pos[4][3][64];
    Scans() {
        for (int log2 = 0; log2 < 4; ++log2) {
            const int n = 1 << log2;
            int i = 0, x = 0, y = 0;
            while (i < n * n) {
                while (y >= 0) {
                    if (x < n && y < n) pos[log2][0][i++] = static_cast<uint8_t>(x | y << 4);
                    --y;
                    ++x;
                }
                y = x;
                x = 0;
            }
            for (int k = 0; k < n * n; ++k) {
                pos[log2][1][k] = static_cast<uint8_t>((k % n) | (k / n) << 4);
                pos[log2][2][k] = static_cast<uint8_t>((k / n) | (k % n) << 4);
            }
        }
    }
};
const Scans kScans;

// ---------------------------------------------------------------------------
// Reconstruction shared by the decoder and the encoder.
// ---------------------------------------------------------------------------

int chroma_qp_map(int qpi) {
    if (qpi < 30) return qpi;
    if (qpi > 43) return qpi - 6;
    return kChromaQp[qpi - 30];
}

// Dequantised (flat scaling, m = 16), inverse transformed residual of an
// n x n block ([y][x]) into `res`.
void residual(const int32_t* level, int log2, int qp, bool dst, bool ts, bool bypass,
              int32_t* res, int64_t* stats) {
    const int n = 1 << log2, nn = n * n;
    if (bypass) {
        std::memcpy(res, level, sizeof(int32_t) * nn);
        return;
    }
    int32_t d[32 * 32];
    const int bd_shift = log2 + 3;
    const int64_t scale = int64_t(16) * kLevelScale[qp % 6] << (qp / 6);
    for (int k = 0; k < nn; ++k) {
        const int64_t v = (level[k] * scale + (int64_t(1) << (bd_shift - 1))) >> bd_shift;
        d[k] = static_cast<int32_t>(std::max<int64_t>(-32768, std::min<int64_t>(32767, v)));
    }
    if (ts) {
        for (int k = 0; k < nn; ++k) res[k] = (d[k] * 128 + 2048) >> 12;
        return;
    }
    if (stats) ++stats[dst ? kStatDst : kStatDct4 + log2 - 2];
    // The n-point matrix, rows the basis functions. Every sum fits 32 bits:
    // at most 32 products of |90| and a 16-bit value.
    const int step = 32 >> log2;
    int32_t m[32 * 32];
    for (int k = 0; k < n; ++k)
        for (int i = 0; i < n; ++i) m[k * n + i] = dst ? kDst[k][i] : kTransform[k * step][i];
    int32_t g[32 * 32];
    int rows = 0;                               // the rows of g that are not all zero
    for (int x = 0; x < n; ++x) {               // columns
        int last = -1;
        for (int k = 0; k < n; ++k)
            if (d[k * n + x]) last = k;
        if (last < 0) {
            for (int y = 0; y < n; ++y) g[y * n + x] = 0;
            continue;
        }
        for (int y = 0; y < n; ++y) {
            int32_t e = 0;
            for (int k = 0; k <= last; ++k) e += m[k * n + y] * d[k * n + x];
            g[y * n + x] = clip3(-32768, 32767, (e + 64) >> 7);
        }
        rows = n;
    }
    for (int y = 0; y < n; ++y) {               // rows
        const int32_t* gy = g + y * n;
        int last = -1;
        for (int k = 0; k < n && rows; ++k)
            if (gy[k]) last = k;
        for (int x = 0; x < n; ++x) {
            int32_t r = 0;
            for (int k = 0; k <= last; ++k) r += m[k * n + x] * gy[k];
            res[y * n + x] = (r + 2048) >> 12;
        }
    }
}

struct Recon {
    Picture& pic;
    const int32_t* p;
    int64_t* stats = nullptr;

    // Intra sample prediction (8.4.4.2) of an n x n block of component c
    // at (xc, yc) in that component's samples, written into the plane.
    void predict(int c, int xc, int yc, int log2, int mode) {
        const int n = 1 << log2, sh = c ? 1 : 0;
        uint8_t* plane = pic.plane[c];
        const int stride = pic.stride[c];
        const int xy = xc << sh, yy = yc << sh;
        // line[0] = p[-1][2n-1] ... line[2n-1] = p[-1][0], line[2n] =
        // p[-1][-1], line[2n+1+x] = p[x][-1].
        int line[4 * 64 + 1];
        bool avail[4 * 64 + 1];
        bool any = false;
        for (int i = 0; i <= 4 * n; ++i) {
            int x, y;
            if (i < 2 * n) {
                x = -1;
                y = 2 * n - 1 - i;
            } else {
                x = i - 2 * n - 1;
                y = -1;
            }
            avail[i] = pic.available(xy, yy, (xc + x) << sh, (yc + y) << sh);
            if (avail[i]) {
                line[i] = plane[(yc + y) * stride + xc + x];
                any = true;
            }
        }
        if (!any) {
            for (int i = 0; i <= 4 * n; ++i) line[i] = 128;
        } else {
            if (!avail[0]) {
                int k = 1;
                while (!avail[k]) ++k;
                line[0] = line[k];
            }
            for (int i = 1; i <= 4 * n; ++i)
                if (!avail[i]) line[i] = line[i - 1];
        }
        // Filtering (8.4.4.2.3), luma only in 4:2:0.
        if (c == 0 && mode != 1 && n != 4) {
            const int dist = std::min(std::abs(mode - 26), std::abs(mode - 10));
            const int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
            if (dist > thres) {
                int f[4 * 64 + 1];
                const int corner = line[2 * n], bottom = line[0], right = line[4 * n];
                if (p[kStrongSmoothing] && n == 32 &&
                    std::abs(corner + right - 2 * line[3 * n]) < 8 &&
                    std::abs(corner + bottom - 2 * line[n]) < 8) {
                    if (stats) ++stats[kStatStrongSmoothing];
                    for (int y = 0; y < 63; ++y)
                        f[63 - y] = ((63 - y) * corner + (y + 1) * bottom + 32) >> 6;
                    for (int x = 0; x < 63; ++x)
                        f[65 + x] = ((63 - x) * corner + (x + 1) * right + 32) >> 6;
                    f[0] = bottom;
                    f[64] = corner;
                    f[128] = right;
                } else {
                    if (stats) ++stats[kStatFiltered];
                    f[0] = line[0];
                    f[4 * n] = line[4 * n];
                    for (int i = 1; i < 4 * n; ++i)
                        f[i] = (line[i - 1] + 2 * line[i] + line[i + 1] + 2) >> 2;
                }
                std::memcpy(line, f, sizeof(int) * (4 * n + 1));
            }
        }
        auto left = [&](int y) { return line[2 * n - 1 - y]; };   // p[-1][y], y >= -1
        auto top = [&](int x) { return line[2 * n + 1 + x]; };    // p[x][-1], x >= -1
        uint8_t* out = plane + yc * stride + xc;
        if (mode == 0) {                                          // planar
            for (int y = 0; y < n; ++y)
                for (int x = 0; x < n; ++x)
                    out[y * stride + x] = static_cast<uint8_t>(
                        ((n - 1 - x) * left(y) + (x + 1) * top(n) + (n - 1 - y) * top(x) +
                         (y + 1) * left(n) + n) >> (log2 + 1));
            return;
        }
        if (mode == 1) {                                          // DC
            int sum = n;
            for (int i = 0; i < n; ++i) sum += top(i) + left(i);
            const int dc = sum >> (log2 + 1);
            for (int y = 0; y < n; ++y)
                for (int x = 0; x < n; ++x) out[y * stride + x] = static_cast<uint8_t>(dc);
            if (c == 0 && n < 32) {
                out[0] = static_cast<uint8_t>((left(0) + 2 * dc + top(0) + 2) >> 2);
                for (int x = 1; x < n; ++x)
                    out[x] = static_cast<uint8_t>((top(x) + 3 * dc + 2) >> 2);
                for (int y = 1; y < n; ++y)
                    out[y * stride] = static_cast<uint8_t>((left(y) + 3 * dc + 2) >> 2);
            }
            return;
        }
        const int angle = kIntraPredAngle[mode - 2];
        int refbuf[3 * 64 + 1];
        int* ref = refbuf + 64;
        const bool vertical = mode >= 18;
        auto main_side = [&](int k) { return vertical ? top(k) : left(k); };
        auto side = [&](int k) { return vertical ? left(k) : top(k); };
        for (int x = 0; x <= n; ++x) ref[x] = main_side(x - 1);
        if (angle < 0) {
            const int inv = kInvAngle[mode - 11];
            if ((n * angle) >> 5 < -1)
                for (int x = (n * angle) >> 5; x <= -1; ++x)
                    ref[x] = side(-1 + ((x * inv + 128) >> 8));
        } else {
            for (int x = n + 1; x <= 2 * n; ++x) ref[x] = main_side(x - 1);
        }
        for (int j = 0; j < n; ++j) {           // j: y for vertical, x for horizontal
            const int idx = ((j + 1) * angle) >> 5, fact = ((j + 1) * angle) & 31;
            for (int i = 0; i < n; ++i) {
                const int v = fact ? ((32 - fact) * ref[i + idx + 1] + fact * ref[i + idx + 2] + 16) >> 5
                                   : ref[i + idx + 1];
                if (vertical)
                    out[j * stride + i] = static_cast<uint8_t>(v);
                else
                    out[i * stride + j] = static_cast<uint8_t>(v);
            }
        }
        if (c == 0 && n < 32) {
            if (mode == 26)
                for (int y = 0; y < n; ++y)
                    out[y * stride] = static_cast<uint8_t>(clip1(top(0) + ((left(y) - left(-1)) >> 1)));
            else if (mode == 10)
                for (int x = 0; x < n; ++x)
                    out[x] = static_cast<uint8_t>(clip1(left(0) + ((top(x) - top(-1)) >> 1)));
        }
    }

    void add(int c, int xc, int yc, int log2, const int32_t* res) {
        const int n = 1 << log2, stride = pic.stride[c];
        uint8_t* out = pic.plane[c] + yc * stride + xc;
        for (int y = 0; y < n; ++y)
            for (int x = 0; x < n; ++x)
                out[y * stride + x] = static_cast<uint8_t>(clip1(out[y * stride + x] + res[y * n + x]));
    }
};

// Motion compensation (8.5.3.3.3): the luma (8-tap, quarter samples) or
// chroma (4-tap, eighth samples) interpolation of a w x h block at (x0, y0)
// of a pw x ph reference plane displaced by (mvx, mvy), at 14 bits, each
// reference sample's coordinates clamped to the picture.
void interpolate(const uint8_t* ref, int pw, int ph, int x0, int y0, int w, int h, int mvx, int mvy,
                 bool chroma, int16_t* out, int64_t* stats) {
    const int frac_bits = chroma ? 3 : 2, taps = chroma ? 4 : 8, before = taps / 2 - 1;
    const int fx = mvx & ((1 << frac_bits) - 1), fy = mvy & ((1 << frac_bits) - 1);
    const int xi = x0 + (mvx >> frac_bits) - before, yi = y0 + (mvy >> frac_bits) - before;
    const int ww = w + taps - 1, wh = h + taps - 1;
    uint8_t win[(64 + 7) * (64 + 7)];
    if (stats) {
        if (xi < 0 || yi < 0 || xi + ww > pw || yi + wh > ph) ++stats[kStatMcOutside];
        if (fx && fy && !chroma) ++stats[kStatMcFracBoth];
    }
    for (int j = 0; j < wh; ++j) {
        const uint8_t* row = ref + static_cast<size_t>(clip3(0, ph - 1, yi + j)) * pw;
        for (int i = 0; i < ww; ++i) win[j * ww + i] = row[clip3(0, pw - 1, xi + i)];
    }
    auto tap = [&](int f, int k) { return chroma ? kChromaFilter[f][k] : kLumaFilter[f][k]; };
    if (!fx && !fy) {
        for (int j = 0; j < h; ++j)
            for (int i = 0; i < w; ++i) out[j * w + i] = static_cast<int16_t>(win[(j + before) * ww + i + before] << 6);
    } else if (!fy) {
        for (int j = 0; j < h; ++j)
            for (int i = 0; i < w; ++i) {
                int v = 0;
                for (int k = 0; k < taps; ++k) v += tap(fx, k) * win[(j + before) * ww + i + k];
                out[j * w + i] = static_cast<int16_t>(v);
            }
    } else if (!fx) {
        for (int j = 0; j < h; ++j)
            for (int i = 0; i < w; ++i) {
                int v = 0;
                for (int k = 0; k < taps; ++k) v += tap(fy, k) * win[(j + k) * ww + i + before];
                out[j * w + i] = static_cast<int16_t>(v);
            }
    } else {
        int16_t tmp[(64 + 7) * 64];
        for (int j = 0; j < wh; ++j)
            for (int i = 0; i < w; ++i) {
                int v = 0;
                for (int k = 0; k < taps; ++k) v += tap(fx, k) * win[j * ww + i + k];
                tmp[j * w + i] = static_cast<int16_t>(v);
            }
        for (int j = 0; j < h; ++j)
            for (int i = 0; i < w; ++i) {
                int v = 0;
                for (int k = 0; k < taps; ++k) v += tap(fy, k) * tmp[(j + k) * w + i];
                out[j * w + i] = static_cast<int16_t>(v >> 6);
            }
    }
}

// The scan of a transform block (7.4.9.11): by intra mode for 4x4 blocks
// and 8x8 luma.
int scan_idx(int log2, int c, int mode) {
    if (log2 == 2 || (log2 == 3 && c == 0)) {
        if (mode >= 6 && mode <= 14) return 2;
        if (mode >= 22 && mode <= 30) return 1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// A plan of one coding unit (the encoder's choices, in coding order).
// ---------------------------------------------------------------------------

struct TuNode {
    int8_t split, cbf_cb, cbf_cr, cbf_luma, ts[3];
    int32_t coeff[3];           // index into CuPlan::levels, -1: none
};

// A prediction unit's choices: merge and its index, or the lists
// (inter_pred_idc: 1 L0, 2 L1, 3 both), each list's reference index, the
// vector wanted and the predictor chosen (mvp_lX_flag).
struct PuPlan {
    int merge = 0, merge_idx = 0, pf = 1, ref[2] = {0, 0}, mvp[2] = {0, 0};
    Mv mv[2];
};

struct CuPlan {
    int bypass, nxn, pcm, chroma_mode;
    int modes[4];
    int qp_delta;               // coded when a transform unit has a coefficient
    int intra = 1, skip = 0, part = kPart2Nx2N, root = 0;
    PuPlan pu[4];
    std::vector<TuNode> nodes;  // pre-order
    std::vector<int32_t> levels;
    size_t cursor = 0;
};

// A small seeded generator (splitmix64).
struct Rng {
    uint64_t s;
    uint64_t next() {
        uint64_t z = (s += 0x9E3779B97F4A7C15ull);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    }
    int below(int n) { return static_cast<int>(next() % static_cast<uint64_t>(n)); }
    bool chance(int per_mille) { return below(1000) < per_mille; }
};

// The plan's knobs (hevc.py's KNOBS).
enum Knob {
    kKnobBest,           // 1: the best intra mode / motion by SAD (a real picture), 0: seeded
    kKnobSplitCu, kKnobBypass, kKnobPcm, kKnobNxN, kKnobSplitTu, kKnobTs, kKnobQpDelta,
    kKnobDeadZone, kKnobChroma4, kKnobMaxLevel,
    // P and B slices: the shares (per mille) of inter coding units, skipped
    // ones, parts other than 2Nx2N, AMP parts among those, merged prediction
    // units and bi-prediction; the vectors' range (quarter samples) and the
    // best-motion search's (whole samples).
    kKnobInter, kKnobSkip, kKnobPart, kKnobAmp, kKnobMerge, kKnobBi, kKnobMvRange, kKnobSearch,
    kKnobInts
};

// The prediction units of a coding unit of `size` in PartMode `part`:
// (x, y, w, h) of each, relative to the coding unit; returns their count.
int pu_boxes(int part, int size, int boxes[4][4]) {
    const int half = size >> 1, quarter = size >> 2;
    int n = 0;
    auto box = [&](int x, int y, int w, int h) {
        boxes[n][0] = x;
        boxes[n][1] = y;
        boxes[n][2] = w;
        boxes[n++][3] = h;
    };
    switch (part) {
        case kPart2Nx2N: box(0, 0, size, size); break;
        case kPart2NxN: box(0, 0, size, half); box(0, half, size, half); break;
        case kPartNx2N: box(0, 0, half, size); box(half, 0, half, size); break;
        case kPart2NxnU: box(0, 0, size, quarter); box(0, quarter, size, size - quarter); break;
        case kPart2NxnD: box(0, 0, size, size - quarter); box(0, size - quarter, size, quarter); break;
        case kPartnLx2N: box(0, 0, quarter, size); box(quarter, 0, size - quarter, size); break;
        case kPartnRx2N: box(0, 0, size - quarter, size); box(size - quarter, 0, quarter, size); break;
        default:
            box(0, 0, half, half); box(half, 0, half, half);
            box(0, half, half, half); box(half, half, half, half);
    }
    return n;
}

// ---------------------------------------------------------------------------
// The coding tree layer, for the decoder (E = cabac::Decoder) and the
// encoder (E = cabac::Encoder).
// ---------------------------------------------------------------------------

template <class E>
struct Coder {
    E e;
    Picture& pic;
    const int32_t* p;
    const Slice& s;
    int slice_index;
    Recon rec;
    int64_t* stats = nullptr;
    // The encoder's inputs.
    const uint8_t* const* src = nullptr;
    const int32_t* knobs = nullptr;
    Rng* rng = nullptr;
    CuPlan plan;

    // P and B slices: the reference pictures' planes (three a slot), the
    // collocated picture's motion field (kColInts a 16x16 block; null: no
    // temporal candidates).
    const uint8_t* const* refs = nullptr;
    const int32_t* col = nullptr;

    int min_cb, min_tb, max_tb, qg_log2;
    // Quantisation group state (8.6.1).
    int qp_prev, qp_pred = 0, qp_y, qp_delta_val = 0;
    bool qp_delta_coded = false;
    int cu_chroma_mode = 1, cu_bypass = 0;
    // The coding unit's prediction mode, PartMode, whether its first
    // prediction unit merges, and interSplitFlag's condition.
    bool cu_intra = true, cu_merge0 = false, cu_inter_split = false;
    int status = kOk;

    Coder(Picture& pic_, const int32_t* p_, const Slice& s_, int index)
        : pic(pic_), p(p_), s(s_), slice_index(index), rec{pic_, p_} {
        min_cb = p[kMinCbLog2];
        min_tb = p[kMinTbLog2];
        max_tb = p[kMaxTbLog2];
        qg_log2 = pic.ctb_log2 - p[kQpDeltaDepth];
        qp_prev = qp_y = s.qp;
    }

    static constexpr bool kEnc = E::kEncode;
    int bin(int ctx, int v) { return e.decision(ctx, v); }
    int byp(int v) { return e.bypass(v); }
    int bits(int n, int v) {
        int out = 0;
        for (int i = n - 1; i >= 0; --i) out = out << 1 | byp(v >> i & 1);
        return out;
    }

    void count(int k) {
        if (stats) ++stats[k];
    }

    void init_contexts() {
        const int qp = clip3(0, 51, s.qp);
        const uint8_t* init = kInitValues[s.init_type];
        for (int k = 0; k < kNumContexts; ++k) {
            const int m = (init[k] >> 4) * 5 - 45, n = ((init[k] & 15) << 3) - 16;
            const int pre = clip3(1, 126, ((m * qp) >> 4) + n);
            e.state[k] = static_cast<uint8_t>(pre <= 63 ? (63 - pre) << 1 : (pre - 64) << 1 | 1);
        }
    }

    // --- SAO syntax (7.3.8.3) ----------------------------------------------

    void sao(int rx, int ry, const SaoParams* want) {
        const int addr = ry * pic.ctbs_w + rx;
        SaoParams& out = pic.sao[addr];
        out = SaoParams{};
        int merge_left = 0, merge_up = 0;
        if (rx > 0 && addr - 1 >= s.addr) {
            merge_left = bin(kCtxSaoMerge, kEnc ? want->type[0] == -1 : 0);
            if (kEnc && merge_left) ++stats[kStatSaoMergeLeft];
        }
        if (ry > 0 && !merge_left && addr - pic.ctbs_w >= s.addr) {
            merge_up = bin(kCtxSaoMerge, kEnc ? want->type[0] == -2 : 0);
            if (kEnc && merge_up) ++stats[kStatSaoMergeUp];
        }
        if (merge_left || merge_up) {
            out = pic.sao[merge_left ? addr - 1 : addr - pic.ctbs_w];
            return;
        }
        for (int c = 0; c < 3; ++c) {
            if (!(c == 0 ? s.sao_luma : s.sao_chroma)) continue;
            int type;
            if (c < 2) {
                const int v = kEnc ? want->type[c] : 0;
                type = bin(kCtxSaoType, v != 0) ? 1 + byp(v == 2) : 0;
            } else {
                type = out.type[1];
            }
            out.type[c] = static_cast<int8_t>(type);
            if (!type) continue;
            int abs_[4];
            for (int i = 0; i < 4; ++i) {       // TR, cMax 7, bypass
                const int v = kEnc ? std::abs(want->offset[c][i + 1]) : 0;
                int k = 0;
                while (k < 7 && byp(k < v)) ++k;
                abs_[i] = k;
            }
            if (type == 1) {
                for (int i = 0; i < 4; ++i) {
                    int v = abs_[i];
                    if (v && byp(kEnc ? want->offset[c][i + 1] < 0 : 0)) v = -v;
                    out.offset[c][i + 1] = static_cast<int8_t>(v);
                }
                out.band[c] = static_cast<int8_t>(bits(5, kEnc ? want->band[c] : 0));
                if (kEnc) ++stats[kStatSaoBand];
            } else {
                for (int i = 0; i < 4; ++i)
                    out.offset[c][i + 1] = static_cast<int8_t>(i < 2 ? abs_[i] : -abs_[i]);
                out.eo_class[c] = c < 2 ? static_cast<int8_t>(bits(2, kEnc ? want->eo_class[c] : 0))
                                        : out.eo_class[1];
                if (kEnc) ++stats[kStatSaoEdge0 + out.eo_class[c]];
            }
        }
    }

    // --- The coding quadtree (7.3.8.4) ----------------------------------------

    int depth_at(int x, int y) const { return pic.depth[pic.at4(x, y)]; }

    void quadtree(int x0, int y0, int log2, int depth) {
        if (status) return;
        const int size = 1 << log2;
        int split;
        if (x0 + size <= pic.w && y0 + size <= pic.h && log2 > min_cb) {
            int inc = 0;
            if (pic.available(x0, y0, x0 - 1, y0) && depth_at(x0 - 1, y0) > depth) ++inc;
            if (pic.available(x0, y0, x0, y0 - 1) && depth_at(x0, y0 - 1) > depth) ++inc;
            int want = 0;
            if (kEnc)   // a real picture's inter units are 16x16
                want = knobs[kKnobBest] && s.type != kSliceI ? log2 > 4 : rng->chance(knobs[kKnobSplitCu]);
            split = bin(kCtxSplitCu + inc, want);
        } else {
            split = log2 > min_cb;
        }
        if (log2 >= qg_log2) {
            qp_delta_coded = false;
            qp_delta_val = 0;
        }
        if (split) {
            const int half = size >> 1;
            quadtree(x0, y0, log2 - 1, depth + 1);
            if (x0 + half < pic.w) quadtree(x0 + half, y0, log2 - 1, depth + 1);
            if (y0 + half < pic.h) quadtree(x0, y0 + half, log2 - 1, depth + 1);
            if (x0 + half < pic.w && y0 + half < pic.h) quadtree(x0 + half, y0 + half, log2 - 1, depth + 1);
        } else {
            coding_unit(x0, y0, log2, depth);
        }
    }

    int wrap_qp(int v) const { return ((v + 52) % 52 + 52) % 52; }

    // --- The coding unit (7.3.8.5) ---------------------------------------------

    int mpm_candidate(int xpb, int ypb, int xn, int yn, bool above) {
        if (!pic.available(xpb, ypb, xn, yn)) return 1;
        if (pic.flags[pic.at4(xn, yn)] & kFlagPcm) return 1;
        if (above && yn < ((ypb >> pic.ctb_log2) << pic.ctb_log2)) return 1;
        return pic.ipm[pic.at4(xn, yn)];
    }

    void mpm_list(int xpb, int ypb, int* list) {
        const int a = mpm_candidate(xpb, ypb, xpb - 1, ypb, false);
        const int b = mpm_candidate(xpb, ypb, xpb, ypb - 1, true);
        if (a == b) {
            if (a < 2) {
                list[0] = 0;
                list[1] = 1;
                list[2] = 26;
            } else {
                list[0] = a;
                list[1] = 2 + ((a + 29) % 32);
                list[2] = 2 + ((a - 2 + 1) % 32);
            }
        } else {
            list[0] = a;
            list[1] = b;
            list[2] = (a != 0 && b != 0) ? 0 : ((a != 1 && b != 1) ? 1 : 26);
        }
    }

    void coding_unit(int x0, int y0, int log2, int depth) {
        const int size = 1 << log2;
        // The quantisation group's predicted QP, at its first coding unit.
        const int qg_mask = (1 << qg_log2) - 1;
        const int xq = x0 & ~qg_mask, yq = y0 & ~qg_mask;
        if (x0 == xq && y0 == yq) {
            const int ctb_mask = (1 << pic.ctb_log2) - 1;
            const int qa = (xq & ctb_mask) ? pic.qp[pic.at4(xq - 1, yq)] : qp_prev;
            const int qb = (yq & ctb_mask) ? pic.qp[pic.at4(xq, yq - 1)] : qp_prev;
            qp_pred = (qa + qb + 1) >> 1;
            if (kEnc && ((xq & ctb_mask) || (yq & ctb_mask))) ++stats[kStatCuQpPred];
        }
        qp_y = wrap_qp(qp_pred + qp_delta_val);
        pic.fill4(pic.depth, x0, y0, size, static_cast<uint8_t>(depth));

        if (kEnc) plan_cu(x0, y0, log2);
        cu_bypass = p[kBypassEnabled] ? bin(kCtxBypass, kEnc ? plan.bypass : 0) : 0;
        int skip = 0;
        if (s.type != kSliceI) {
            int inc = 0;
            if (pic.available(x0, y0, x0 - 1, y0) && pic.skip[pic.at4(x0 - 1, y0)]) ++inc;
            if (pic.available(x0, y0, x0, y0 - 1) && pic.skip[pic.at4(x0, y0 - 1)]) ++inc;
            skip = bin(kCtxSkip + inc, kEnc ? plan.skip : 0);
        }
        pic.fill4(pic.skip, x0, y0, size, static_cast<uint8_t>(skip));
        int intra = 1;
        if (!skip && s.type != kSliceI) intra = bin(kCtxPredMode, kEnc ? plan.intra : 0);
        cu_intra = intra && !skip;
        int part = kPart2Nx2N;
        if (!skip && (!intra || log2 == min_cb)) part = part_mode(intra, log2);
        const int nxn = intra && part == kPartNxN;
        int pcm = 0;
        if (cu_intra && !nxn && p[kPcmEnabled] && log2 >= p[kPcmMinLog2] && log2 <= p[kPcmMaxLog2])
            pcm = e.terminate(kEnc ? plan.pcm : 0);
        if (kEnc) {
            stats[kStatBypass] += cu_bypass;
            stats[kStatNxN] += nxn;
            if (s.type != kSliceI && cu_intra) ++stats[kStatIntraInInter];
            if (!cu_intra && cu_bypass) ++stats[kStatInterBypass];
        }
        uint8_t cu_flags = 0;
        if (pcm) cu_flags |= kFlagPcm | (p[kPcmNoFilter] ? kFlagNoFilter : 0);
        if (cu_bypass) cu_flags |= kFlagNoFilter;
        pic.fill4(pic.flags, x0, y0, size, cu_flags);
        pic.mark_edges(x0, y0, size);
        if (!cu_intra) {
            // Inter: the prediction units, then the residual's quadtree.
            pic.fill4(pic.ipm, x0, y0, size, uint8_t(1));
            if (skip) {
                count(kStatSkip);
                prediction_unit(x0, y0, log2, depth, 0, x0, y0, size, size, kPart2Nx2N, true);
            } else {
                if (kEnc && part != kPart2Nx2N) ++stats[kStatPart2NxN + part - 1];
                int boxes[4][4];
                const int n = pu_boxes(part, size, boxes);
                for (int i = 0; i < n && !status; ++i)
                    prediction_unit(x0, y0, log2, depth, i, x0 + boxes[i][0], y0 + boxes[i][1], boxes[i][2],
                                    boxes[i][3], part, false);
                int root = 1;
                if (!(part == kPart2Nx2N && cu_merge0)) root = bin(kCtxRqtRootCbf, kEnc ? plan.root : 0);
                if (kEnc && !root) ++stats[kStatRootCbf0];
                cu_inter_split = p[kMaxDepthInter] == 0 && part != kPart2Nx2N;
                if (root)
                    transform_tree(x0, y0, x0, y0, log2, 0, 0, 0, p[kMaxDepthInter], 0, 0);
            }
        } else if (pcm) {
            pic.fill4(pic.mvf, x0, y0, size, Mvf{});
            pcm_samples(x0, y0, log2);
            pic.fill4(pic.ipm, x0, y0, size, uint8_t(1));
        } else {
            pic.fill4(pic.mvf, x0, y0, size, Mvf{});
            const int parts = nxn ? 4 : 1, pb = nxn ? size >> 1 : size;
            int prev[4], mode[4], mpm_want[4] = {}, rem_want[4] = {};
            if (kEnc) {
                // The planned modes are in ipm (plan_cu): each PB's list
                // reads only the PBs before it, as the decoder's does.
                for (int i = 0; i < parts; ++i) {
                    int list[3];
                    mpm_list(x0 + (i & 1) * pb, y0 + (i >> 1) * pb, list);
                    mpm_want[i] = -1;
                    for (int k = 0; k < 3; ++k)
                        if (list[k] == plan.modes[i]) mpm_want[i] = k;
                    std::sort(list, list + 3);
                    int r = plan.modes[i];
                    for (int k = 2; k >= 0; --k)
                        if (plan.modes[i] > list[k]) --r;
                    rem_want[i] = r;
                }
            }
            for (int i = 0; i < parts; ++i) prev[i] = bin(kCtxPrevIntra, mpm_want[i] >= 0);
            for (int i = 0; i < parts; ++i) {
                const int xp = x0 + (i & 1) * pb, yp = y0 + (i >> 1) * pb;
                int list[3];
                mpm_list(xp, yp, list);
                int m;
                if (prev[i]) {
                    const int v = mpm_want[i];
                    m = list[byp(v > 0) ? 1 + byp(v > 1) : 0];
                    if (kEnc) ++stats[kStatMpm];
                } else {
                    m = bits(5, rem_want[i]);
                    std::sort(list, list + 3);
                    for (int k = 0; k < 3; ++k)
                        if (m >= list[k]) ++m;
                    if (kEnc) ++stats[kStatRemMode];
                }
                mode[i] = m;
                pic.fill4(pic.ipm, xp, yp, pb, static_cast<uint8_t>(m));
                if (kEnc) ++stats[kStatLumaMode + 35 * std::min(3, (nxn ? log2 - 1 : log2) - 2) + m];
            }
            int chroma = 4;
            {
                const int v = kEnc ? plan.chroma_mode : 0;
                if (bin(kCtxChromaMode, v != 4)) chroma = bits(2, v);
            }
            if (kEnc) ++stats[kStatChromaMode + chroma];
            static const int kChromaModes[4] = {0, 26, 10, 1};
            cu_chroma_mode = chroma == 4 ? mode[0] : kChromaModes[chroma];
            if (chroma != 4 && cu_chroma_mode == mode[0]) {
                cu_chroma_mode = 34;
                if (kEnc) ++stats[kStatChroma34];
            }
            cu_inter_split = false;
            transform_tree(x0, y0, x0, y0, log2, 0, 0, nxn, p[kMaxDepthIntra] + nxn, 0, 0);
        }
        pic.fill4(pic.qp, x0, y0, size, static_cast<int8_t>(qp_y));
        qp_prev = qp_y;
    }

    // part_mode (9.3.3.7, Table 9-43; FFmpeg's contexts: the AMP bin after
    // the first two takes the fourth).
    int part_mode(int intra, int log2) {
        const int v = kEnc ? plan.part : 0;
        if (bin(kCtxPartMode, v == kPart2Nx2N)) return kPart2Nx2N;
        if (intra) return kPartNxN;
        if (log2 == min_cb) {
            if (bin(kCtxPartModeInter, v == kPart2NxN)) return kPart2NxN;
            if (log2 == 3) return kPartNx2N;
            return bin(kCtxPartModeInter + 1, v == kPartNx2N) ? kPartNx2N : kPartNxN;
        }
        const bool horizontal = v == kPart2NxN || v == kPart2NxnU || v == kPart2NxnD;
        if (!p[kAmpEnabled]) return bin(kCtxPartModeInter, horizontal) ? kPart2NxN : kPartNx2N;
        if (bin(kCtxPartModeInter, horizontal)) {
            if (bin(kCtxPartModeInter + 2, v == kPart2NxN)) return kPart2NxN;
            return byp(v == kPart2NxnD) ? kPart2NxnD : kPart2NxnU;
        }
        if (bin(kCtxPartModeInter + 2, v == kPartNx2N)) return kPartNx2N;
        return byp(v == kPartnRx2N) ? kPartnRx2N : kPartnLx2N;
    }

    // --- Inter prediction (7.3.8.6, 8.5.3) ----------------------------------------

    // The prediction unit at (xp, yp), w x h, of the coding unit at (xc, yc)
    // of size 1 << log2: its syntax, its motion derived and stored, and its
    // samples predicted into the planes.
    void prediction_unit(int xc, int yc, int log2, int depth, int idx, int xp, int yp, int w, int h,
                         int part, bool skip) {
        const PuPlan* want = kEnc ? &plan.pu[idx] : nullptr;
        int merge = skip;
        if (!skip) merge = bin(kCtxMergeFlag, kEnc ? want->merge : 0);
        if (idx == 0) cu_merge0 = merge;
        Mvf m;
        if (merge) {
            int k = 0;
            const int v = kEnc ? want->merge_idx : 0;
            while (k < s.max_merge - 1 && (k ? byp(k < v) : bin(kCtxMergeIdx, k < v))) ++k;
            const int kind = merge_candidate(xc, yc, log2, xp, yp, w, h, idx, part, k, m);
            if (kEnc) {
                ++stats[kStatMergeIdx + k];
                if (kind) ++stats[kStatMergeTemporal + kind - 1];
            }
        } else {
            int pf = 1;
            if (s.type == kSliceB) {
                const int v = kEnc ? want->pf : 0;
                if (w + h != 12 && bin(kCtxInterPred + depth, v == 3))
                    pf = 3;
                else
                    pf = bin(kCtxInterPred + 4, v == 2) ? 2 : 1;
            }
            Mv mvd[2];
            int flag[2] = {0, 0};
            m.pf = static_cast<uint8_t>(pf);
            for (int l = 0; l < 2; ++l) {
                if (!(pf >> l & 1)) continue;
                int k = 0;
                const int v = kEnc ? want->ref[l] : 0;
                while (k < s.nref[l] - 1 && (k < 2 ? bin(kCtxRefIdx + k, k < v) : byp(k < v))) ++k;
                m.ref[l] = static_cast<int8_t>(k);
                if (kEnc) {
                    if (k) ++stats[kStatRefIdx1];
                    if (k > 2) ++stats[kStatRefIdxBypass];
                }
                Mv cand[2];
                if (kEnc) {
                    // The planner's vector less the predictor it picked.
                    amvp(xc, yc, log2, xp, yp, w, h, idx, l, k, cand);
                    mvd[l] = Mv{want->mv[l].x - cand[want->mvp[l]].x, want->mv[l].y - cand[want->mvp[l]].y};
                }
                if (l == 1 && s.mvd_l1_zero && pf == 3) {
                    if (kEnc && mvd[1] != Mv{}) status = kErrArgs;
                    mvd[1] = Mv{};
                    count(kStatMvdL1Zero);
                } else {
                    mvd_coding(mvd[l]);
                }
                flag[l] = bin(kCtxMvpFlag, kEnc ? want->mvp[l] : 0);
                if (kEnc && flag[l]) ++stats[kStatMvp1];
            }
            for (int l = 0; l < 2; ++l) {
                if (!(pf >> l & 1)) continue;
                Mv cand[2];
                amvp(xc, yc, log2, xp, yp, w, h, idx, l, m.ref[l], cand);
                m.mv[l] = Mv{wrap16(cand[flag[l]].x + mvd[l].x), wrap16(cand[flag[l]].y + mvd[l].y)};
            }
            if (kEnc) {
                ++stats[kStatAmvp];
                ++stats[kStatPredL0 + pf - 1];
            }
        }
        pic.fill4(pic.mvf, xp, yp, w, h, m);
        predict_pu(xp, yp, w, h, m);
    }

    void mvd_coding(Mv& mvd) {
        int v[2] = {mvd.x, mvd.y}, g0[2], g1[2] = {0, 0};
        for (int k = 0; k < 2; ++k) g0[k] = bin(kCtxMvdGt0, kEnc ? v[k] != 0 : 0);
        for (int k = 0; k < 2; ++k)
            if (g0[k]) g1[k] = bin(kCtxMvdGt1, kEnc ? std::abs(v[k]) > 1 : 0);
        for (int k = 0; k < 2; ++k) {
            if (!g0[k]) {
                v[k] = 0;
                continue;
            }
            int a = 1;
            if (g1[k]) {
                a = 2 + exp_golomb(1, kEnc ? std::abs(v[k]) - 2 : 0);
                if (kEnc) ++stats[kStatMvdEscape];
            }
            v[k] = byp(kEnc ? v[k] < 0 : 0) ? -a : a;
        }
        mvd = Mv{v[0], v[1]};
    }

    // k-th order Exp-Golomb, bypass (9.3.3.3).
    int exp_golomb(int k, int v) {
        if (kEnc) {
            int rest = v;
            while (rest >= (1 << k)) {
                byp(1);
                rest -= 1 << k;
                ++k;
            }
            byp(0);
            bits(k, rest);
            return v;
        }
        int out = 0;
        while (byp(0)) {
            out += 1 << k;
            if (++k > 30) {
                status = kErrCoefficient;
                return 0;
            }
        }
        return out + bits(k, 0);
    }

    const Mvf& motion(int x, int y) const { return pic.mvf[pic.at4(x, y)]; }
    int ref_poc(int l, int idx) const { return s.ref[l][idx].poc; }

    // 6.4.2: the availability of a prediction block's neighbour (xn, yn).
    bool pb_available(int xc, int yc, int nc, int xp, int yp, int w, int h, int idx, int xn, int yn) const {
        bool avail;
        if (xc <= xn && yc <= yn && xn < xc + nc && yn < yc + nc)
            avail = !((w << 1) == nc && (h << 1) == nc && idx == 1 && yc + h <= yn && xc + w > xn);
        else
            avail = pic.available(xp, yp, xn, yn);
        return avail && motion(xn, yn).pf != 0;
    }

    // The merge candidate merge_idx (8.5.3.2.2 - 8.5.3.2.5) into `out`;
    // returns its kind: 0 spatial, 1 temporal, 2 combined bi-predictive, 3
    // zero.
    int merge_candidate(int xc, int yc, int log2, int xp, int yp, int w, int h, int idx, int part,
                        int merge_idx, Mvf& out) {
        const int nc = 1 << log2, w_orig = w, h_orig = h;
        const int mer = p[kParMrgLevel];
        if (mer > 2 && nc == 8) {       // singleMCLFlag
            xp = xc;
            yp = yc;
            w = h = nc;
            idx = 0;
            count(kStatSingleMcl);
        }
        Mvf list[5];
        int kinds[5] = {}, n = 0;
        auto same_mer = [&](int xn, int yn) {
            const bool same = (xp >> mer) == (xn >> mer) && (yp >> mer) == (yn >> mer);
            if (same && pic.available(xp, yp, xn, yn) && motion(xn, yn).pf) count(kStatMerExcluded);
            return same;
        };
        auto avail = [&](int xn, int yn) {
            return !same_mer(xn, yn) && pb_available(xc, yc, nc, xp, yp, w, h, idx, xn, yn);
        };
        const int xa1 = xp - 1, ya1 = yp + h - 1, xb1 = xp + w - 1, yb1 = yp - 1;
        const bool a1 = avail(xa1, ya1) && !(idx == 1 && (part == kPartNx2N || part == kPartnLx2N ||
                                                          part == kPartnRx2N));
        if (a1) list[n++] = motion(xa1, ya1);
        const bool b1 = avail(xb1, yb1) && !(idx == 1 && (part == kPart2NxN || part == kPart2NxnU ||
                                                          part == kPart2NxnD));
        if (b1 && !(a1 && same_motion(motion(xa1, ya1), motion(xb1, yb1)))) list[n++] = motion(xb1, yb1);
        const int xb0 = xp + w, yb0 = yp - 1;
        if (avail(xb0, yb0) && !(b1 && same_motion(motion(xb1, yb1), motion(xb0, yb0))))
            list[n++] = motion(xb0, yb0);
        const int xa0 = xp - 1, ya0 = yp + h;
        if (avail(xa0, ya0) && !(a1 && same_motion(motion(xa1, ya1), motion(xa0, ya0))))
            list[n++] = motion(xa0, ya0);
        const int xb2 = xp - 1, yb2 = yp - 1;
        if (n != 4 && avail(xb2, yb2) && !(a1 && same_motion(motion(xa1, ya1), motion(xb2, yb2))) &&
            !(b1 && same_motion(motion(xb1, yb1), motion(xb2, yb2))))
            list[n++] = motion(xb2, yb2);
        if (s.tmvp && n <= merge_idx) {
            Mvf c;
            if (temporal(xp, yp, w, h, 0, 0, c.mv[0])) c.pf |= 1;
            if (s.type == kSliceB && temporal(xp, yp, w, h, 0, 1, c.mv[1])) c.pf |= 2;
            if (c.pf) {
                kinds[n] = 1;
                list[n++] = c;
            }
        }
        const int orig = n, max = s.max_merge;
        if (s.type == kSliceB && orig > 1 && orig < max && n <= merge_idx) {
            static const int kL0[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
            static const int kL1[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};
            for (int k = 0; k < orig * (orig - 1) && n < max; ++k) {
                const Mvf &a = list[kL0[k]], &b = list[kL1[k]];
                if ((a.pf & 1) && (b.pf & 2) &&
                    (ref_poc(0, a.ref[0]) != ref_poc(1, b.ref[1]) || a.mv[0] != b.mv[1])) {
                    Mvf c;
                    c.pf = 3;
                    c.mv[0] = a.mv[0];
                    c.ref[0] = a.ref[0];
                    c.mv[1] = b.mv[1];
                    c.ref[1] = b.ref[1];
                    kinds[n] = 2;
                    list[n++] = c;
                }
            }
        }
        const int refs = s.type == kSliceP ? s.nref[0] : std::min(s.nref[0], s.nref[1]);
        for (int zero = 0; n < max; ++zero) {
            Mvf c;
            c.pf = s.type == kSliceP ? 1 : 3;
            c.ref[0] = c.ref[1] = static_cast<int8_t>(zero < refs ? zero : 0);
            kinds[n] = 3;
            list[n++] = c;
        }
        out = list[merge_idx];
        if (out.pf == 3 && w_orig + h_orig == 12) {
            out.pf = 1;
            count(kStatBiTo8x4);
        }
        return kinds[merge_idx];
    }

    // The collocated vector of list X's refIdx for the block at (x, y) of the
    // collocated picture's field (8.5.3.2.9): false when none.
    bool col_vector(int x, int y, int ref_idx, int X, Mv& out) {
        const int w16 = (pic.w + 15) >> 4;
        const int32_t* c = col + (static_cast<size_t>(y >> 4) * w16 + (x >> 4)) * kColInts;
        const int pf = c[kColFlags];
        if (!pf) return false;
        const int list = !(pf & 1) ? 1 : (pf == 1 ? 0 : (s.no_backward ? X : s.col_from_l0));
        const RefEntry& cur = s.ref[X][ref_idx];
        if (cur.lt != c[kColLt0 + list]) return false;
        const Mv mv{c[kColMv0x + 2 * list], c[kColMv0y + 2 * list]};
        const int col_poc = s.ref[s.col_from_l0 ? 0 : 1][s.col_ref].poc;
        const int col_diff = col_poc - c[kColPoc0 + list], cur_diff = p[kPoc] - cur.poc;
        if (cur.lt || col_diff == cur_diff || !col_diff) {
            out = mv;
        } else {
            out = scale_mv(mv, col_diff, cur_diff);
            count(kStatTmvpScaled);
        }
        return true;
    }

    // The temporal luma vector predictor (8.5.3.2.8): the collocated
    // picture's bottom-right block, else its central one, at 16x16
    // granularity.
    bool temporal(int xp, int yp, int w, int h, int ref_idx, int X, Mv& out) {
        if (!col) return false;
        const int x = xp + w, y = yp + h;
        if ((yp >> pic.ctb_log2) == (y >> pic.ctb_log2) && y < pic.h && x < pic.w &&
            col_vector(x & ~15, y & ~15, ref_idx, X, out))
            return true;
        return col_vector((xp + (w >> 1)) & ~15, (yp + (h >> 1)) & ~15, ref_idx, X, out);
    }

    // The two predictors of list X's vector to reference ref_idx
    // (8.5.3.2.6, 8.5.3.2.7).
    void amvp(int xc, int yc, int log2, int xp, int yp, int w, int h, int idx, int X, int ref_idx,
              Mv* out) {
        const int nc = 1 << log2, cur_poc = ref_poc(X, ref_idx), cur_lt = s.ref[X][ref_idx].lt;
        auto avail = [&](int xn, int yn) { return pb_available(xc, yc, nc, xp, yp, w, h, idx, xn, yn); };
        auto same_picture = [&](const Mvf& m, int l, Mv& mv) {
            if (!(m.pf >> l & 1) || ref_poc(l, m.ref[l]) != cur_poc) return false;
            mv = m.mv[l];
            return true;
        };
        auto scaled = [&](const Mvf& m, int l, Mv& mv) {
            if (!(m.pf >> l & 1) || s.ref[l][m.ref[l]].lt != cur_lt) return false;
            mv = m.mv[l];
            const int poc = ref_poc(l, m.ref[l]);
            if (!cur_lt && poc != cur_poc) {
                mv = scale_mv(mv, p[kPoc] - poc ? p[kPoc] - poc : 1, p[kPoc] - cur_poc);
                count(kStatAmvpScaled);
            }
            return true;
        };
        const int xa[2] = {xp - 1, xp - 1}, ya[2] = {yp + h, yp + h - 1};
        const bool av_a[2] = {avail(xa[0], ya[0]), avail(xa[1], ya[1])};
        const bool is_scaled = av_a[0] || av_a[1];
        bool found_a = false, found_b = false;
        Mv mva, mvb;
        for (int k = 0; k < 2 && !found_a; ++k)
            if (av_a[k]) found_a = same_picture(motion(xa[k], ya[k]), X, mva) || same_picture(motion(xa[k], ya[k]), !X, mva);
        for (int k = 0; k < 2 && !found_a; ++k)
            if (av_a[k]) found_a = scaled(motion(xa[k], ya[k]), X, mva) || scaled(motion(xa[k], ya[k]), !X, mva);
        const int xb[3] = {xp + w, xp + w - 1, xp - 1}, yb[3] = {yp - 1, yp - 1, yp - 1};
        const bool av_b[3] = {avail(xb[0], yb[0]), avail(xb[1], yb[1]), avail(xb[2], yb[2])};
        for (int k = 0; k < 3 && !found_b; ++k)
            if (av_b[k]) found_b = same_picture(motion(xb[k], yb[k]), X, mvb) || same_picture(motion(xb[k], yb[k]), !X, mvb);
        if (!is_scaled) {
            if (found_b) {
                found_a = true;
                mva = mvb;
            }
            found_b = false;
            for (int k = 0; k < 3 && !found_b; ++k)
                if (av_b[k]) found_b = scaled(motion(xb[k], yb[k]), X, mvb) || scaled(motion(xb[k], yb[k]), !X, mvb);
        }
        int n = 0;
        if (found_a) out[n++] = mva;
        if (found_b && !(found_a && mva == mvb)) out[n++] = mvb;
        if (n < 2 && s.tmvp) {
            Mv mv;
            if (temporal(xp, yp, w, h, ref_idx, X, mv)) {
                out[n++] = mv;
                count(kStatAmvpTemporal);
            }
        }
        while (n < 2) out[n++] = Mv{};
    }

    // The weighted sample prediction of a prediction unit (8.5.3.3.4):
    // default, or explicit where the slice's PPS asks for it.
    // With `luma`, only the luma prediction, into `luma` (stride w).
    void predict_pu(int xp, int yp, int w, int h, const Mvf& m, uint8_t* luma = nullptr) {
        static thread_local int16_t pred[2][64 * 64];
        for (int c = 0; c < (luma ? 1 : 3); ++c) {
            const int sh = c ? 1 : 0, bw = w >> sh, bh = h >> sh, xc = xp >> sh, yc = yp >> sh;
            for (int l = 0; l < 2; ++l)
                if (m.pf >> l & 1)
                    interpolate(refs[3 * s.ref[l][m.ref[l]].slot + c], pic.w >> sh, pic.h >> sh, xc, yc, bw, bh,
                                m.mv[l].x, m.mv[l].y, c > 0, pred[l], stats);
            const int stride = luma ? w : pic.stride[c];
            uint8_t* out = luma ? luma : pic.plane[c] + yc * stride + xc;
            const int shift = s.denom[c > 0] + 6;
            if (m.pf == 3) {
                const RefEntry &r0 = s.ref[0][m.ref[0]], &r1 = s.ref[1][m.ref[1]];
                if (s.weighted) count(kStatWeightedBi);
                for (int y = 0; y < bh; ++y)
                    for (int x = 0; x < bw; ++x) {
                        const int a = pred[0][y * bw + x], b = pred[1][y * bw + x];
                        out[y * stride + x] = static_cast<uint8_t>(clip1(
                            s.weighted ? (a * r0.w[c] + b * r1.w[c] + ((r0.o[c] + r1.o[c] + 1) << shift)) >> (shift + 1)
                                       : (a + b + 64) >> 7));
                    }
            } else {
                const int l = m.pf == 1 ? 0 : 1;
                const RefEntry& r = s.ref[l][m.ref[l]];
                if (s.weighted) count(kStatWeightedUni);
                for (int y = 0; y < bh; ++y)
                    for (int x = 0; x < bw; ++x) {
                        const int a = pred[l][y * bw + x];
                        out[y * stride + x] = static_cast<uint8_t>(clip1(
                            s.weighted ? ((a * r.w[c] + (1 << (shift - 1))) >> shift) + r.o[c] : (a + 32) >> 6));
                    }
            }
        }
    }

    // pcm_alignment_zero_bit, pcm_sample(), then the arithmetic engine
    // initialised again (9.3.2.5).
    void pcm_samples(int x0, int y0, int log2) {
        const int size = 1 << log2;
        if constexpr (kEnc) {
            ++stats[kStatPcm];
            e.w->align_zero();
        } else {
            e.r->pos = (e.r->pos + 7) & ~int64_t(7);
            const int64_t need = int64_t(size) * size * p[kPcmBitsY] + int64_t(size) * size / 2 * p[kPcmBitsC];
            if (e.r->pos + need > e.r->size_bits) {
                status = kErrOverrun;
                return;
            }
        }
        for (int c = 0; c < 3; ++c) {
            const int sh = c ? 1 : 0, n = size >> sh, stride = pic.stride[c];
            const int depth = c ? p[kPcmBitsC] : p[kPcmBitsY];
            uint8_t* out = pic.plane[c] + (y0 >> sh) * stride + (x0 >> sh);
            for (int y = 0; y < n; ++y)
                for (int x = 0; x < n; ++x) {
                    int v;
                    if constexpr (kEnc) {
                        v = src[c][((y0 >> sh) + y) * stride + (x0 >> sh) + x] >> (8 - depth);
                        e.w->put(depth, v);
                    } else {
                        v = static_cast<int>(e.r->get(depth));
                    }
                    out[y * stride + x] = static_cast<uint8_t>(v << (8 - depth));
                }
        }
        e.start();
    }

    // --- The transform tree (7.3.8.8 - 7.3.8.10) -------------------------------

    void transform_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, int intra_split,
                        int max_depth, int parent_cb, int parent_cr) {
        if (status) return;
        const TuNode* node = kEnc ? &plan.nodes[plan.cursor++] : nullptr;
        int split;
        if (log2 <= max_tb && log2 > min_tb && depth < max_depth && !(intra_split && depth == 0)) {
            split = bin(kCtxSplitTf + 5 - log2, kEnc ? node->split : 0);
        } else {
            split = log2 > max_tb || ((intra_split || cu_inter_split) && depth == 0);
            if (kEnc && cu_inter_split && depth == 0 && log2 <= max_tb) ++stats[kStatInterSplit];
        }
        int cb = 0, cr = 0;
        if (log2 > 2) {
            if (depth == 0 || parent_cb) cb = bin(kCtxCbfChroma + depth, kEnc ? node->cbf_cb : 0);
            if (depth == 0 || parent_cr) cr = bin(kCtxCbfChroma + depth, kEnc ? node->cbf_cr : 0);
        } else {
            cb = parent_cb;
            cr = parent_cr;
        }
        if (split) {
            const int half = 1 << (log2 - 1);
            for (int k = 0; k < 4; ++k)
                transform_tree(x0 + (k & 1) * half, y0 + (k >> 1) * half, x0, y0, log2 - 1, depth + 1, k,
                               intra_split, max_depth, cb, cr);
            return;
        }
        int luma = 1;
        if (cu_intra || depth || cb || cr)
            luma = bin(kCtxCbfLuma + (depth == 0), kEnc ? node->cbf_luma : 0);
        else if (kEnc && !node->cbf_luma)
            status = kErrCoefficient;       // a plan whose inferred cbf_luma has no coefficient
        else
            count(kStatCbfLumaInferred);
        transform_unit(x0, y0, xb, yb, log2, blk, luma, cb, cr, node);
    }

    int chroma_qp(int c) const {
        const int off = c == 1 ? p[kCbOffset] + s.cb_offset : p[kCrOffset] + s.cr_offset;
        return chroma_qp_map(clip3(0, 57, qp_y + off));
    }

    void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, int luma, int cb, int cr,
                        const TuNode* node) {
        // Inter blocks are predicted already; their scan is the diagonal.
        const int mode = cu_intra ? pic.ipm[pic.at4(x0, y0)] : -1;
        pic.fill4(pic.cbf, x0, y0, 1 << log2, static_cast<uint8_t>(luma));
        if ((luma || cb || cr) && p[kQpDeltaEnabled] && !qp_delta_coded) {
            const int v = kEnc ? plan.qp_delta : 0;
            int a = std::abs(v), k = 0;
            while (k < 5 && bin(kCtxQpDelta + (k > 0), k < a)) ++k;
            if (k == 5) {
                // EG0 suffix, bypass.
                int sfx = kEnc ? a - 5 : 0, n = 0;
                if (kEnc) {
                    while (sfx >= (1 << n)) {
                        byp(1);
                        sfx -= 1 << n;
                        ++n;
                    }
                    byp(0);
                    bits(n, sfx);
                    if (kEnc) ++stats[kStatQpDeltaSuffix];
                } else {
                    while (byp(0)) {
                        if (++n > 16) {
                            status = kErrQpDelta;
                            return;
                        }
                    }
                    k = 5 + (1 << n) - 1 + bits(n, 0);
                }
                if (kEnc) k = a;
            }
            a = k;
            int val = a;
            if (a && byp(kEnc ? v < 0 : 0)) val = -a;
            if (val < -26 || val > 25) {
                status = kErrQpDelta;
                return;
            }
            qp_delta_coded = true;
            qp_delta_val = val;
            qp_y = wrap_qp(qp_pred + val);
            if (kEnc && val) ++stats[kStatQpDelta];
        }
        pic.mark_edges(x0, y0, 1 << log2);
        const int cmode = cu_intra ? cu_chroma_mode : -1;
        if (cu_intra) rec.predict(0, x0, y0, log2, mode);
        if (luma) block(0, x0, y0, log2, mode, node);
        if (log2 > 2) {
            if (cu_intra) rec.predict(1, x0 >> 1, y0 >> 1, log2 - 1, cmode);
            if (cb) block(1, x0 >> 1, y0 >> 1, log2 - 1, cmode, node);
            if (cu_intra) rec.predict(2, x0 >> 1, y0 >> 1, log2 - 1, cmode);
            if (cr) block(2, x0 >> 1, y0 >> 1, log2 - 1, cmode, node);
        } else if (blk == 3) {
            if (kEnc) ++stats[kStatChromaTb4At3];
            if (cu_intra) rec.predict(1, xb >> 1, yb >> 1, 2, cmode);
            if (cb) block(1, xb >> 1, yb >> 1, 2, cmode, node);
            if (cu_intra) rec.predict(2, xb >> 1, yb >> 1, 2, cmode);
            if (cr) block(2, xb >> 1, yb >> 1, 2, cmode, node);
        }
    }

    // One transform block: its residual coded, then added to the
    // prediction already in the plane.
    void block(int c, int xc, int yc, int log2, int mode, const TuNode* node) {
        int32_t level[32 * 32], res[32 * 32];
        const int n = 1 << log2;
        const int32_t* want = kEnc ? &plan.levels[node->coeff[c]] : nullptr;
        int ts = 0;
        if (p[kTransformSkip] && !cu_bypass && log2 == 2) {
            ts = bin(kCtxTransformSkip + (c > 0), kEnc ? node->ts[c] : 0);
            if (kEnc) stats[kStatTransformSkip] += ts;
        }
        if (kEnc) std::memcpy(level, want, sizeof(int32_t) * n * n);
        residual_coding(level, log2, c, scan_idx(log2, c, mode));
        if (status) return;
        const int qp = c ? chroma_qp(c) : qp_y;
        residual(level, log2, qp, cu_intra && c == 0 && log2 == 2, ts, cu_bypass, res, kEnc ? stats : nullptr);
        rec.add(c, xc, yc, log2, res);
    }

    // --- residual_coding (7.3.8.11) ----------------------------------------------

    void last_prefix(int ctx0, int log2, int c, int v, int* out) {
        const int offset = c ? 15 : 3 * (log2 - 2) + ((log2 - 1) >> 2);
        const int shift = c ? log2 - 2 : (log2 + 1) >> 2;
        const int cmax = (log2 << 1) - 1;
        int k = 0;
        while (k < cmax && bin(ctx0 + offset + (k >> shift), k < v)) ++k;
        *out = k;
    }

    static int prefix_of(int pos) {
        if (pos < 4) return pos;
        int k = 31 - __builtin_clz(pos);              // pos in [2^k, 2^(k+1))
        return 2 * k + ((pos >> (k - 1)) & 1);
    }

    void residual_coding(int32_t* level, int log2, int c, int scan) {
        const int n = 1 << log2, sb_log2 = log2 - 2, sbs = 1 << sb_log2;
        if (kEnc && scan) ++stats[scan == 1 ? kStatScanHor : kStatScanVer];
        const uint8_t* sb_scan = kScans.pos[sb_log2][scan];
        const uint8_t* in_scan = kScans.pos[2][scan];
        // The encoder's last position.
        int last_x = 0, last_y = 0, last_sb = 0, last_pos = 0;
        if (kEnc) {
            for (int i = sbs * sbs - 1; i >= 0 && !last_sb; --i)
                for (int k = 15; k >= 0; --k) {
                    const int x = (sb_scan[i] & 15) * 4 + (in_scan[k] & 15);
                    const int y = (sb_scan[i] >> 4) * 4 + (in_scan[k] >> 4);
                    if (level[y * n + x]) {
                        last_x = x;
                        last_y = y;
                        last_sb = i + 1;
                        last_pos = k;
                        break;
                    }
                }
            if (!last_sb) {
                status = kErrCoefficient;      // a coded block flag over no coefficient
                return;
            }
            --last_sb;
        }
        // Coded as (x, y), swapped for the vertical scan.
        int cx = scan == 2 ? last_y : last_x, cy = scan == 2 ? last_x : last_y;
        int px, py;
        last_prefix(kCtxLastX, log2, c, prefix_of(cx), &px);
        last_prefix(kCtxLastY, log2, c, prefix_of(cy), &py);
        auto suffix = [&](int prefix, int v) {
            if (prefix <= 3) return prefix;
            const int nb = (prefix >> 1) - 1, base = (1 << nb) * (2 + (prefix & 1));
            return base + bits(nb, v - base);
        };
        cx = suffix(px, cx);
        cy = suffix(py, cy);
        if (cx >= n || cy >= n) {
            status = kErrCoefficient;
            return;
        }
        last_x = scan == 2 ? cy : cx;
        last_y = scan == 2 ? cx : cy;
        if (!kEnc) {
            // The sub-block and position of the last coefficient.
            const int sx = last_x >> 2, sy = last_y >> 2, ix = last_x & 3, iy = last_y & 3;
            for (int i = 0; i < sbs * sbs; ++i)
                if ((sb_scan[i] & 15) == sx && (sb_scan[i] >> 4) == sy) last_sb = i;
            for (int k = 0; k < 16; ++k)
                if ((in_scan[k] & 15) == ix && (in_scan[k] >> 4) == iy) last_pos = k;
            std::memset(level, 0, sizeof(int32_t) * n * n);
        }
        uint8_t csbf[8][8] = {};
        int greater1_ctx = 1;
        const bool hiding_allowed = p[kSignHiding] && !cu_bypass;
        for (int i = last_sb; i >= 0; --i) {
            const int xs = sb_scan[i] & 15, ys = sb_scan[i] >> 4;
            int32_t* lv[16];
            for (int k = 0; k < 16; ++k)
                lv[k] = &level[(ys * 4 + (in_scan[k] >> 4)) * n + xs * 4 + (in_scan[k] & 15)];
            bool infer_dc = false;
            int coded = 1;
            const int right = xs + 1 < sbs ? csbf[xs + 1][ys] : 0;
            const int below = ys + 1 < sbs ? csbf[xs][ys + 1] : 0;
            if (i < last_sb && i > 0) {
                int any = 0;
                if (kEnc)
                    for (int k = 0; k < 16; ++k) any |= *lv[k] != 0;
                coded = bin(kCtxCsbf + std::min(right + below, 1) + (c ? 2 : 0), any);
                if (kEnc && !coded) ++stats[kStatCsbfZero];
                infer_dc = true;
            }
            csbf[xs][ys] = static_cast<uint8_t>(coded);
            int sig[16] = {};
            const int first_n = i == last_sb ? last_pos - 1 : 15;
            if (i == last_sb) sig[last_pos] = 1;
            const int prev_csbf = right + 2 * below;
            for (int k = first_n; k >= 0 && coded; --k) {
                if (k == 0 && infer_dc) {
                    sig[0] = 1;
                    break;
                }
                const int x = xs * 4 + (in_scan[k] & 15), y = ys * 4 + (in_scan[k] >> 4);
                int ctx;
                if (log2 == 2) {
                    ctx = kCtxIdxMap[(y << 2) + x];
                } else if (x + y == 0) {
                    ctx = 0;
                } else {
                    const int xp = x & 3, yp = y & 3;
                    if (prev_csbf == 0)
                        ctx = xp + yp == 0 ? 2 : (xp + yp < 3 ? 1 : 0);
                    else if (prev_csbf == 1)
                        ctx = yp == 0 ? 2 : (yp == 1 ? 1 : 0);
                    else if (prev_csbf == 2)
                        ctx = xp == 0 ? 2 : (xp == 1 ? 1 : 0);
                    else
                        ctx = 2;
                    if (c == 0) {
                        if (xs || ys) ctx += 3;
                        ctx += log2 == 3 ? (scan == 0 ? 9 : 15) : 21;
                    } else {
                        ctx += log2 == 3 ? 9 : 12;
                    }
                }
                sig[k] = bin(kCtxSig + (c ? 27 + ctx : ctx), kEnc ? *lv[k] != 0 : 0);
                if (sig[k]) infer_dc = false;
            }
            // Levels.
            int first_sig = 16, last_sig = -1, num_g1 = 0, last_g1_pos = -1;
            int g1[16] = {}, g2[16] = {};
            int ctx_set = (i == 0 || c > 0) ? 0 : 2;
            bool any_sig = false;
            for (int k = 15; k >= 0; --k) any_sig |= sig[k] != 0;
            if (!any_sig) continue;
            if (i != last_sb && greater1_ctx == 0) ++ctx_set;
            greater1_ctx = 1;
            for (int k = 15; k >= 0; --k) {
                if (!sig[k]) continue;
                if (num_g1 < 8) {
                    const int inc = ctx_set * 4 + std::min(3, greater1_ctx) + (c ? 16 : 0);
                    g1[k] = bin(kCtxGt1 + inc, kEnc ? std::abs(*lv[k]) > 1 : 0);
                    ++num_g1;
                    if (g1[k]) {
                        greater1_ctx = 0;
                        if (last_g1_pos == -1) last_g1_pos = k;
                    } else if (greater1_ctx > 0) {
                        ++greater1_ctx;
                    }
                }
                if (last_sig == -1) last_sig = k;
                first_sig = k;
            }
            const bool hidden = hiding_allowed && last_sig - first_sig > 3;
            if (last_g1_pos != -1)
                g2[last_g1_pos] = bin(kCtxGt2 + ctx_set + (c ? 4 : 0),
                                      kEnc ? std::abs(*lv[last_g1_pos]) > 2 : 0);
            int signs[16] = {};
            for (int k = 15; k >= 0; --k)
                if (sig[k] && (!hidden || k != first_sig)) signs[k] = byp(kEnc ? *lv[k] < 0 : 0);
            if (kEnc && hidden) ++stats[kStatSignHidden];
            int num_sig = 0, sum = 0, rice = 0;
            for (int k = 15; k >= 0; --k) {
                if (!sig[k]) continue;
                const int base = 1 + g1[k] + g2[k];
                int value = base;
                if (base == ((num_sig < 8) ? (k == last_g1_pos ? 3 : 2) : 1)) {
                    const int rem = remaining(rice, kEnc ? std::abs(*lv[k]) - base : 0);
                    if (status) return;
                    value = base + rem;
                    if (value > 3 * (1 << rice)) rice = std::min(rice + 1, 4);
                    if (kEnc && rice == 4) ++stats[kStatRice4];
                }
                if (value > 32768) {
                    status = kErrCoefficient;
                    return;
                }
                int v = signs[k] ? -value : value;
                if (hidden) {
                    sum += value;
                    if (k == first_sig && (sum & 1)) v = -v;
                }
                if (!kEnc) *lv[k] = v;
                else if (*lv[k] != v) status = kErrCoefficient;   // sign hiding not planned
                ++num_sig;
            }
        }
    }

    int remaining(int rice, int v) {
        // Prefix: TR with cMax 4 << rice, then EG(rice + 1) (9.3.3.11).
        if (kEnc) {
            if (v < (4 << rice)) {
                for (int k = 0; k < (v >> rice); ++k) byp(1);
                byp(0);
                bits(rice, v & ((1 << rice) - 1));
            } else {
                ++stats[kStatEscape];
                int rest = v - (4 << rice), k = rice + 1, ones = 4;
                while (rest >= (1 << k)) {
                    rest -= 1 << k;
                    ++k;
                    ++ones;
                }
                for (int j = 0; j < ones; ++j) byp(1);
                byp(0);
                bits(k, rest);
            }
            return v;
        }
        int prefix = 0;
        while (prefix < 32 && byp(0)) ++prefix;
        if (prefix >= 32) {
            status = kErrCoefficient;
            return 0;
        }
        if (prefix < 4) return (prefix << rice) + bits(rice, 0);
        const int k = prefix - 3 + rice;
        return (((1 << (prefix - 3)) + 2) << rice) + bits(k, 0);
    }

    // --- The encoder's plan of a coding unit -------------------------------------

    void plan_cu(int x0, int y0, int log2);
    void plan_pu(int xc, int yc, int log2, int idx, int xp, int yp, int w, int h, int part);
    void best_pu(int xc, int yc, int log2, int idx, int xp, int yp, int w, int h, int part, Mvf& m);
    int luma_sad(int xp, int yp, int w, int h, const Mvf& m);
    void plan_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, int intra_split,
                   int max_depth, int qp, const int* modes);
    int plan_block(int c, int xc, int yc, int log2, int mode, int qp, TuNode& node);
    int best_mode(int x, int y, int log2);
};

// The encoder's choices of one coding unit, and the quantised levels of
// each of its blocks, reconstructed as the decoder will.
template <class E>
void Coder<E>::plan_cu(int x0, int y0, int log2) {
    plan = CuPlan{};
    const bool best = knobs[kKnobBest] != 0;
    plan.bypass = p[kBypassEnabled] && rng->chance(knobs[kKnobBypass]);
    if (s.type != kSliceI) plan.intra = best ? 0 : !rng->chance(knobs[kKnobInter]);
    auto plan_qp = [&] {
        const int range = knobs[kKnobQpDelta];
        plan.qp_delta = qp_delta_coded ? qp_delta_val : 0;
        if (!qp_delta_coded && range) {
            // Keep the QP at or above 0 and at most 51 without the wrap.
            const int lo = std::max({-range, -qp_pred, -26}), hi = std::min({range, 51 - qp_pred, 25});
            plan.qp_delta = lo + rng->below(hi - lo + 1);
        }
        return wrap_qp(qp_pred + plan.qp_delta);
    };
    cu_bypass = plan.bypass;
    if (!plan.intra) {
        const int qp = plan_qp();
        cu_intra = false;
        const int size = 1 << log2;
        plan.skip = !best && rng->chance(knobs[kKnobSkip]);
        if (!plan.skip && !best && rng->chance(knobs[kKnobPart])) {
            int choices[8], n = 0;
            choices[n++] = kPart2NxN;
            choices[n++] = kPartNx2N;
            if (log2 == min_cb && log2 > 3) choices[n++] = kPartNxN;
            plan.part = choices[rng->below(n)];
            if (p[kAmpEnabled] && log2 > min_cb && rng->chance(knobs[kKnobAmp])) plan.part = kPart2NxnU + rng->below(4);
        }
        int boxes[4][4];
        const int parts = pu_boxes(plan.part, size, boxes);
        for (int i = 0; i < parts; ++i)
            plan_pu(x0, y0, log2, i, x0 + boxes[i][0], y0 + boxes[i][1], boxes[i][2], boxes[i][3], plan.part);
        pic.fill4(pic.ipm, x0, y0, size, uint8_t(1));
        if (plan.skip) return;
        cu_inter_split = p[kMaxDepthInter] == 0 && plan.part != kPart2Nx2N;
        const int saved_qp = qp_y;
        qp_y = qp;
        plan_tree(x0, y0, x0, y0, log2, 0, 0, 0, p[kMaxDepthInter], qp, nullptr);
        qp_y = saved_qp;
        plan.root = !plan.levels.empty();
        if (!plan.root) {
            plan.nodes.clear();
            // A merged 2Nx2N unit without a residual is a skipped one.
            if (plan.part == kPart2Nx2N && plan.pu[0].merge) plan.skip = 1;
        }
        plan.cursor = 0;
        return;
    }
    cu_intra = true;
    plan.nxn = log2 == min_cb && log2 > min_tb && rng->chance(knobs[kKnobNxN]);
    plan.part = plan.nxn ? kPartNxN : kPart2Nx2N;
    plan.pcm = !plan.nxn && p[kPcmEnabled] && log2 >= p[kPcmMinLog2] && log2 <= p[kPcmMaxLog2] &&
               rng->chance(knobs[kKnobPcm]);
    if (plan.pcm) return;
    const int qp = plan_qp();
    const int parts = plan.nxn ? 4 : 1, pb = (1 << log2) >> plan.nxn;
    for (int i = 0; i < parts; ++i) {
        const int xp = x0 + (i & 1) * pb, yp = y0 + (i >> 1) * pb;
        plan.modes[i] = best ? best_mode(xp, yp, std::min(5, log2 - plan.nxn)) : rng->below(35);
    }
    plan.chroma_mode = best ? 4 : (rng->chance(knobs[kKnobChroma4]) ? 4 : rng->below(4));
    static const int kChromaModes[4] = {0, 26, 10, 1};
    cu_chroma_mode = plan.chroma_mode == 4 ? plan.modes[0] : kChromaModes[plan.chroma_mode];
    if (plan.chroma_mode != 4 && cu_chroma_mode == plan.modes[0]) cu_chroma_mode = 34;
    // The modes as the prediction reads them.
    for (int i = 0; i < parts; ++i)
        pic.fill4(pic.ipm, x0 + (i & 1) * pb, y0 + (i >> 1) * pb, pb, static_cast<uint8_t>(plan.modes[i]));
    pic.fill4(pic.mvf, x0, y0, 1 << log2, Mvf{});
    cu_inter_split = false;
    const int saved_qp = qp_y;
    qp_y = qp;
    plan_tree(x0, y0, x0, y0, log2, 0, 0, plan.nxn, p[kMaxDepthIntra] + plan.nxn, qp, plan.modes);
    qp_y = saved_qp;
    plan.cursor = 0;
}

// One prediction unit's choices, seeded or (kKnobBest) the nearest
// prediction; its motion stored and its samples predicted, as the decoder
// will.
template <class E>
void Coder<E>::plan_pu(int xc, int yc, int log2, int idx, int xp, int yp, int w, int h, int part) {
    PuPlan& pu = plan.pu[idx];
    pu = PuPlan{};
    Mvf m;
    if (knobs[kKnobBest]) {
        best_pu(xc, yc, log2, idx, xp, yp, w, h, part, m);
    } else {
        pu.merge = plan.skip || rng->chance(knobs[kKnobMerge]);
        if (pu.merge) {
            pu.merge_idx = rng->below(s.max_merge);
            merge_candidate(xc, yc, log2, xp, yp, w, h, idx, part, pu.merge_idx, m);
        } else {
            pu.pf = 1;
            if (s.type == kSliceB)
                pu.pf = (w + h != 12 && rng->chance(knobs[kKnobBi])) ? 3 : 1 + rng->below(2);
            m.pf = static_cast<uint8_t>(pu.pf);
            const int range = knobs[kKnobMvRange];
            for (int l = 0; l < 2; ++l) {
                if (!(pu.pf >> l & 1)) continue;
                pu.ref[l] = rng->below(s.nref[l]);
                pu.mvp[l] = rng->below(2);
                Mv cand[2];
                amvp(xc, yc, log2, xp, yp, w, h, idx, l, pu.ref[l], cand);
                Mv mv = cand[pu.mvp[l]];
                if (!(l == 1 && s.mvd_l1_zero && pu.pf == 3)) {
                    const int pick = rng->below(4);
                    if (pick == 1) {
                        mv = Mv{mv.x + rng->below(9) - 4, mv.y + rng->below(9) - 4};
                    } else if (pick > 1) {
                        mv = Mv{rng->below(2 * range + 1) - range, rng->below(2 * range + 1) - range};
                        if (pick == 3) mv = Mv{mv.x & ~3, mv.y & ~3};
                    }
                }
                pu.mv[l] = mv;
                m.mv[l] = mv;
                m.ref[l] = static_cast<int8_t>(pu.ref[l]);
            }
        }
    }
    pic.fill4(pic.mvf, xp, yp, w, h, m);
    predict_pu(xp, yp, w, h, m);
}

// The luma SAD of the prediction `m` of the block at (xp, yp) against the
// target.
template <class E>
int Coder<E>::luma_sad(int xp, int yp, int w, int h, const Mvf& m) {
    const int stride = pic.stride[0];
    uint8_t out[64 * 64];
    predict_pu(xp, yp, w, h, m, out);
    int sad = 0;
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) sad += std::abs(out[y * w + x] - src[0][(yp + y) * stride + xp + x]);
    return sad;
}

// The prediction of a real picture's unit nearest the target: each merge
// candidate, and a search of each list's first reference around its first
// predictor and the zero vector (whole samples within kKnobSearch, then
// half and quarter samples), with both lists' best together in B slices;
// each by SAD plus a rough count of its bits.
template <class E>
void Coder<E>::best_pu(int xc, int yc, int log2, int idx, int xp, int yp, int w, int h, int part, Mvf& m) {
    PuPlan& pu = plan.pu[idx];
    const int lambda = 4;
    int best_cost = INT32_MAX;
    for (int k = 0; k < s.max_merge; ++k) {
        Mvf c;
        merge_candidate(xc, yc, log2, xp, yp, w, h, idx, part, k, c);
        const int cost = luma_sad(xp, yp, w, h, c) + lambda * (1 + k);
        if (cost < best_cost) {
            best_cost = cost;
            m = c;
            pu = PuPlan{};
            pu.merge = 1;
            pu.merge_idx = k;
        }
    }
    auto mv_bits = [](Mv d) {
        auto one = [](int v) { return v ? 2 * (32 - __builtin_clz(std::abs(v))) + 1 : 1; };
        return one(d.x) + one(d.y);
    };
    const int lists = s.type == kSliceB ? 2 : 1, search = knobs[kKnobSearch];
    Mv found[2], pred[2];
    int found_cost[2] = {INT32_MAX, INT32_MAX}, flag[2] = {0, 0};
    for (int l = 0; l < lists; ++l) {
        Mv cand[2];
        amvp(xc, yc, log2, xp, yp, w, h, idx, l, 0, cand);
        Mvf c;
        c.pf = static_cast<uint8_t>(1 << l);
        auto cost_of = [&](Mv mv, int& which) {
            c.mv[l] = mv;
            const int a = mv_bits(Mv{mv.x - cand[0].x, mv.y - cand[0].y});
            const int b = mv_bits(Mv{mv.x - cand[1].x, mv.y - cand[1].y});
            which = b < a;
            return luma_sad(xp, yp, w, h, c) + lambda * (2 + std::min(a, b));
        };
        int which = 0;
        Mv centre{(cand[0].x + 2) & ~3, (cand[0].y + 2) & ~3};
        Mv best_mv{};
        int best = cost_of(best_mv, which);
        int best_which = which;
        for (const Mv& start : {Mv{}, centre}) {
            for (int dy = -search; dy <= search; ++dy)
                for (int dx = -search; dx <= search; ++dx) {
                    const Mv mv{start.x + 4 * dx, start.y + 4 * dy};
                    const int cost = cost_of(mv, which);
                    if (cost < best) {
                        best = cost;
                        best_mv = mv;
                        best_which = which;
                    }
                }
        }
        for (int step : {2, 1}) {
            const Mv around = best_mv;
            for (int dy = -step; dy <= step; dy += step)
                for (int dx = -step; dx <= step; dx += step) {
                    if (!dx && !dy) continue;
                    const Mv mv{around.x + dx, around.y + dy};
                    const int cost = cost_of(mv, which);
                    if (cost < best) {
                        best = cost;
                        best_mv = mv;
                        best_which = which;
                    }
                }
        }
        found[l] = best_mv;
        found_cost[l] = best;
        flag[l] = best_which;
        pred[l] = cand[best_which];
        if (best < best_cost) {
            best_cost = best;
            m = Mvf{};
            m.pf = static_cast<uint8_t>(1 << l);
            m.mv[l] = best_mv;
            pu = PuPlan{};
            pu.pf = 1 << l;
            pu.mv[l] = best_mv;
            pu.mvp[l] = best_which;
        }
    }
    if (lists == 2 && w + h != 12 && !s.mvd_l1_zero) {
        Mvf c;
        c.pf = 3;
        c.mv[0] = found[0];
        c.mv[1] = found[1];
        const int bits = mv_bits(Mv{found[0].x - pred[0].x, found[0].y - pred[0].y}) +
                         mv_bits(Mv{found[1].x - pred[1].x, found[1].y - pred[1].y});
        const int cost = luma_sad(xp, yp, w, h, c) + lambda * (3 + bits);
        if (cost < best_cost && found_cost[0] != INT32_MAX) {
            m = c;
            pu = PuPlan{};
            pu.pf = 3;
            pu.mv[0] = found[0];
            pu.mv[1] = found[1];
            pu.mvp[0] = flag[0];
            pu.mvp[1] = flag[1];
        }
    }
}

template <class E>
void Coder<E>::plan_tree(int x0, int y0, int xb, int yb, int log2, int depth, int blk, int intra_split,
                         int max_depth, int qp, const int* modes) {
    const size_t at = plan.nodes.size();
    plan.nodes.push_back(TuNode{0, 0, 0, 0, {0, 0, 0}, {-1, -1, -1}});
    int split;
    if (log2 <= max_tb && log2 > min_tb && depth < max_depth && !(intra_split && depth == 0))
        split = knobs[kKnobBest] ? log2 > 4 : rng->chance(knobs[kKnobSplitTu]);
    else
        split = log2 > max_tb || ((intra_split || cu_inter_split) && depth == 0);
    plan.nodes[at].split = static_cast<int8_t>(split);
    if (split) {
        const int half = 1 << (log2 - 1);
        for (int k = 0; k < 4; ++k)
            plan_tree(x0 + (k & 1) * half, y0 + (k >> 1) * half, x0, y0, log2 - 1, depth + 1, k,
                      intra_split, max_depth, qp, modes);
        // A node's chroma flags: any chroma coefficient below it.
        if (log2 > 2) {
            for (size_t k = at + 1; k < plan.nodes.size(); ++k) {
                plan.nodes[at].cbf_cb |= plan.nodes[k].cbf_cb;
                plan.nodes[at].cbf_cr |= plan.nodes[k].cbf_cr;
            }
        }
        return;
    }
    TuNode& node = plan.nodes[at];
    const int mode = cu_intra ? pic.ipm[pic.at4(x0, y0)] : -1, cmode = cu_intra ? cu_chroma_mode : -1;
    pic.mark_edges(x0, y0, 1 << log2);
    node.cbf_luma = static_cast<int8_t>(plan_block(0, x0, y0, log2, mode, qp, plan.nodes[at]));
    if (log2 > 2) {
        plan_block(1, x0 >> 1, y0 >> 1, log2 - 1, cmode, qp, plan.nodes[at]);
        plan_block(2, x0 >> 1, y0 >> 1, log2 - 1, cmode, qp, plan.nodes[at]);
    } else if (blk == 3) {
        // The 8x8 node's chroma, coded with its fourth 4x4 luma block: its
        // flags belong to the parent node (the cbf of a log2 2 node is the
        // parent's).
        TuNode& parent = plan.nodes[at - 4];
        plan_block(1, xb >> 1, yb >> 1, 2, cmode, qp, parent);
        plan_block(2, xb >> 1, yb >> 1, 2, cmode, qp, parent);
        plan.nodes[at].cbf_cb = parent.cbf_cb;
        plan.nodes[at].cbf_cr = parent.cbf_cr;
        plan.nodes[at].coeff[1] = parent.coeff[1];
        plan.nodes[at].coeff[2] = parent.coeff[2];
        plan.nodes[at].ts[1] = parent.ts[1];
        plan.nodes[at].ts[2] = parent.ts[2];
    }
}

// Predict, quantise and reconstruct one block; its levels appended to the
// plan. Returns whether any level is nonzero (then `node` records them).
template <class E>
int Coder<E>::plan_block(int c, int xc, int yc, int log2, int mode, int qp_luma, TuNode& node) {
    const int n = 1 << log2, stride = pic.stride[c];
    if (cu_intra) rec.predict(c, xc, yc, log2, mode);
    const uint8_t* pred = pic.plane[c] + yc * stride + xc;
    const uint8_t* target = src[c] + yc * stride + xc;
    int32_t diff[32 * 32], level[32 * 32], res[32 * 32];
    for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) diff[y * n + x] = target[y * stride + x] - pred[y * stride + x];
    const int qp = c ? chroma_qp_map(clip3(0, 57, qp_luma + (c == 1 ? p[kCbOffset] + s.cb_offset
                                                                      : p[kCrOffset] + s.cr_offset)))
                     : qp_luma;
    const bool dst = cu_intra && c == 0 && log2 == 2;
    const int ts = p[kTransformSkip] && !cu_bypass && log2 == 2 && rng->chance(knobs[kKnobTs]);
    // Integer arithmetic only, so that every host writes the same levels.
    // A level L dequantises to d = L * gain with gain = 2 * levelScale *
    // 2^(qp / 6) / n, and the inverse transform takes d to about
    // T' d T / 2^19, so the level of a residual r is T r T' / (32 n^2 gain)
    // = T r T' / den with den = 64 n levelScale 2^(qp / 6); transform skip
    // takes d to d / 32, so its level is 16 n r / (levelScale 2^(qp / 6)).
    const int64_t unit = int64_t(kLevelScale[qp % 6]) << (qp / 6);
    const int64_t limit = std::max<int64_t>(
        1, std::min<int64_t>(knobs[kKnobMaxLevel], 32767 * n / (2 * unit)));
    auto quantise = [&](int64_t num, int64_t den) -> int32_t {
        const int64_t mag = num < 0 ? -num : num;
        const int64_t q = std::min<int64_t>(limit, (mag * 1000 + den * knobs[kKnobDeadZone]) / (den * 1000));
        return static_cast<int32_t>(num < 0 ? -q : q);
    };
    if (cu_bypass) {
        std::memcpy(level, diff, sizeof(level[0]) * n * n);
    } else if (ts) {
        for (int k = 0; k < n * n; ++k) level[k] = quantise(16 * n * int64_t(diff[k]), unit);
    } else {
        int64_t tmp[32 * 32];
        const int step = 32 >> log2;
        auto coef = [&](int k, int i) -> int64_t { return dst ? kDst[k][i] : kTransform[k * step][i]; };
        for (int k = 0; k < n; ++k)
            for (int x = 0; x < n; ++x) {
                int64_t acc = 0;
                for (int y = 0; y < n; ++y) acc += coef(k, y) * diff[y * n + x];
                tmp[k * n + x] = acc;
            }
        for (int k = 0; k < n; ++k)
            for (int j = 0; j < n; ++j) {
                int64_t acc = 0;
                for (int x = 0; x < n; ++x) acc += tmp[k * n + x] * coef(j, x);
                level[k * n + j] = quantise(acc, 64 * n * unit);
            }
    }
    // Sign data hiding: the sign of each hidden sub-block's first
    // coefficient is the parity of its sum; mend the parity by one level.
    if (p[kSignHiding] && !cu_bypass) {
        const int scan = scan_idx(log2, c, mode), sbs = 1 << (log2 - 2);
        const uint8_t* sb_scan = kScans.pos[log2 - 2][scan];
        const uint8_t* in_scan = kScans.pos[2][scan];
        for (int i = 0; i < sbs * sbs; ++i) {
            int32_t* lv[16];
            int first = -1, last = -1, sum = 0;
            for (int k = 0; k < 16; ++k) {
                lv[k] = &level[((sb_scan[i] >> 4) * 4 + (in_scan[k] >> 4)) * n + (sb_scan[i] & 15) * 4 +
                               (in_scan[k] & 15)];
                if (*lv[k]) {
                    if (first < 0) first = k;
                    last = k;
                    sum += std::abs(*lv[k]);
                }
            }
            if (first < 0 || last - first <= 3) continue;
            if ((*lv[first] < 0) != (sum & 1)) {
                int32_t& v = *lv[first];
                const int a = std::abs(v);
                const int na = (a > 1 && (a >= limit || rng->chance(500))) ? a - 1 : a + 1;
                v = v < 0 ? -na : na;
            }
        }
    }
    int any = 0;
    for (int k = 0; k < n * n; ++k) any |= level[k] != 0;
    if (any) {
        node.coeff[c] = static_cast<int32_t>(plan.levels.size());
        plan.levels.insert(plan.levels.end(), level, level + n * n);
        node.ts[c] = static_cast<int8_t>(ts);
        residual(level, log2, qp, dst, ts, cu_bypass, res, nullptr);
        rec.add(c, xc, yc, log2, res);
    }
    if (c == 1) node.cbf_cb = static_cast<int8_t>(any);
    if (c == 2) node.cbf_cr = static_cast<int8_t>(any);
    return any;
}

// The intra mode whose prediction of the block lies nearest the target (the
// sum of absolute differences), from a few candidates.
template <class E>
int Coder<E>::best_mode(int x, int y, int log2) {
    static const int kCandidates[] = {0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 34};
    const int n = 1 << log2, stride = pic.stride[0];
    uint8_t saved[32 * 32];
    uint8_t* out = pic.plane[0] + y * stride + x;
    for (int j = 0; j < n; ++j) std::memcpy(saved + j * n, out + j * stride, n);
    int best = 1, best_sad = INT32_MAX;
    for (int mode : kCandidates) {
        rec.predict(0, x, y, log2, mode);
        int sad = 0;
        for (int j = 0; j < n; ++j)
            for (int i = 0; i < n; ++i) sad += std::abs(out[j * stride + i] - src[0][(y + j) * stride + x + i]);
        if (sad < best_sad) {
            best_sad = sad;
            best = mode;
        }
    }
    for (int j = 0; j < n; ++j) std::memcpy(out + j * stride, saved + j * n, n);
    return best;
}

// ---------------------------------------------------------------------------
// Loop filters.
// ---------------------------------------------------------------------------

// The loop filters (8.7.2, 8.7.3), in the order FFmpeg's hevc decoder runs
// them, which cv2's frames follow where it departs from the standard
// (PERF.md): each CTB deblocked as its deblocking_filter_CTB does (luma in
// bands of 8 rows, vertical edges then the horizontal ones 8 samples
// behind; chroma in bands of 16 luma rows, its horizontal edges 16 luma
// samples behind; the tC / beta offsets taken from a variable the luma
// edges leave set, for chroma the left CTB's where FFmpeg takes them), and
// each CTB's SAO run where ff_hevc_hls_filter runs it, on the samples as
// deblocked so far, with the current CTB's
// slice_loop_filter_across_slices_enabled_flag deciding every slice
// boundary. With kCount it counts its decisions into `stats`; without, the
// decode counts nothing.
template <bool kCount>
struct LoopFilter {
    Picture& pic;
    const int32_t* p;
    const std::vector<Slice>& slices;
    int64_t* stats;                                // kLfStats, when kCount
    std::vector<uint8_t> vbs, hbs;                 // bS of each 4x4 block's left / top edge
    std::vector<uint8_t> sao_out[3], sao_done[3];   // SAO's results, and its CTBs

    void count(int k) const {
        if constexpr (kCount) ++stats[k];
    }
    const Slice& slice_at(int x, int y) const { return slices[pic.slice_of[pic.ctb_at(x, y)]]; }
    int qp(int x, int y) const { return pic.qp[pic.at4(x, y)]; }
    bool no_filter(int x, int y) const { return pic.flags[pic.at4(x, y)] & kFlagNoFilter; }

    // bS of the edge left of (vertical) or above (horizontal) the 4-sample
    // segment at (x, y) on the 8x8 grid (8.7.2.4), as FFmpeg derives it: at
    // a transform or coding block edge, 2 next to an intra block, else 1
    // next to a luma block with coefficients, else the motion's; inside an
    // inter transform block, the motion's (0 within a prediction unit); 0
    // elsewhere.
    int bs(int x, int y, bool vertical) const {
        if (vertical ? (x == 0 || (x & 7)) : (y == 0 || (y & 7))) return 0;
        const bool edge = pic.flags[pic.at4(x, y)] & (vertical ? kFlagEdgeV : kFlagEdgeH);
        const Mvf& q = pic.mvf[pic.at4(x, y)];
        if (!edge && !q.pf) return 0;
        const Slice& qs = slice_at(x, y);
        if (qs.deblock_off) return 0;
        const int xp = vertical ? x - 1 : x, yp = vertical ? y : y - 1;
        if (edge && !qs.across && pic.slice_of[pic.ctb_at(xp, yp)] != pic.slice_of[pic.ctb_at(x, y)]) {
            count(kLfSkippedEdge);
            return 0;
        }
        const Mvf& pm = pic.mvf[pic.at4(xp, yp)];
        if (edge) {
            if (!q.pf || !pm.pf) return 2;
            if (pic.cbf[pic.at4(x, y)] || pic.cbf[pic.at4(xp, yp)]) return 1;
        }
        return motion_bs(qs, q, slice_at(xp, yp), pm);
    }

    // bS 1 for different reference pictures, a different number of
    // vectors, or vectors at least 4 quarter samples apart; else 0.
    static int motion_bs(const Slice& qs, const Mvf& q, const Slice& ps, const Mvf& pm) {
        auto far = [](Mv a, Mv b) { return std::abs(a.x - b.x) >= 4 || std::abs(a.y - b.y) >= 4; };
        if (q.pf == 3 && pm.pf == 3) {
            const int q0 = qs.ref[0][q.ref[0]].poc, q1 = qs.ref[1][q.ref[1]].poc;
            const int p0 = ps.ref[0][pm.ref[0]].poc, p1 = ps.ref[1][pm.ref[1]].poc;
            if (q0 == p0 && q0 == q1 && p0 == p1)
                return (far(q.mv[0], pm.mv[0]) || far(q.mv[1], pm.mv[1])) &&
                       (far(q.mv[0], pm.mv[1]) || far(q.mv[1], pm.mv[0]));
            if (p0 == q0 && p1 == q1) return far(q.mv[0], pm.mv[0]) || far(q.mv[1], pm.mv[1]);
            if (p1 == q0 && p0 == q1) return far(q.mv[0], pm.mv[1]) || far(q.mv[1], pm.mv[0]);
            return 1;
        }
        if (q.pf != 3 && pm.pf != 3) {
            const int lq = q.pf == 1 ? 0 : 1, lp = pm.pf == 1 ? 0 : 1;
            if (qs.ref[lq][q.ref[lq]].poc != ps.ref[lp][pm.ref[lp]].poc) return 1;
            return far(q.mv[lq], pm.mv[lp]);
        }
        return 1;
    }
    int vbs_at(int x, int y) const { return x < pic.w && y < pic.h ? vbs[pic.at4(x, y)] : 0; }
    int hbs_at(int x, int y) const { return x < pic.w && y < pic.h ? hbs[pic.at4(x, y)] : 0; }

    void run() {
        vbs.assign(pic.w4 * pic.h4, 0);
        hbs.assign(pic.w4 * pic.h4, 0);
        for (int y = 0; y < pic.h; y += 4)
            for (int x = 0; x < pic.w; x += 4) {
                vbs[pic.at4(x, y)] = static_cast<uint8_t>(bs(x, y, true));
                hbs[pic.at4(x, y)] = static_cast<uint8_t>(bs(x, y, false));
            }
        // ff_hevc_hls_filters after each CTB in decode order, then
        // ff_hevc_hls_filter of the last.
        const int wc = pic.ctbs_w, hc = pic.ctbs_h;
        if (p[kSaoEnabled])
            for (int c = 0; c < 3; ++c) {
                sao_out[c].assign(static_cast<size_t>(pic.stride[c]) * (c ? pic.h / 2 : pic.h), 0);
                sao_done[c].assign(wc * hc, 0);
            }
        for (int y = 0; y < hc; ++y)
            for (int x = 0; x < wc; ++x) {
                if (y && x) hls_filter(x - 1, y - 1);
                if (y && x == wc - 1) hls_filter(x, y - 1);
                if (x && y == hc - 1) hls_filter(x - 1, y);
            }
        hls_filter(wc - 1, hc - 1);
        for (int c = 0; c < 3; ++c) {
            if (sao_out[c].empty()) continue;
            const int sh = c ? 1 : 0, ctb = (1 << pic.ctb_log2) >> sh, stride = pic.stride[c];
            for (int addr = 0; addr < wc * hc; ++addr) {
                if (!sao_done[c][addr]) continue;
                const int xa = addr % wc * ctb, ya = addr / wc * ctb;
                const int n = std::min(stride, xa + ctb) - xa;
                for (int y = ya; y < std::min(pic.h >> sh, ya + ctb); ++y)
                    std::memcpy(pic.plane[c] + y * stride + xa, sao_out[c].data() + y * stride + xa, n);
            }
        }
    }

    void hls_filter(int x, int y) {
        deblock_ctb(x, y);
        if (!p[kSaoEnabled]) return;
        const bool x_end = x == pic.ctbs_w - 1, y_end = y == pic.ctbs_h - 1;
        if (y && x) sao_ctb(x - 1, y - 1);
        if (x && y_end) sao_ctb(x - 1, y);
        if (y && x_end) sao_ctb(x, y - 1);
        if (x_end && y_end) sao_ctb(x, y);
    }

    int chroma_tc(int qp_y, int c, int tc_offset) const {
        const int off = c == 1 ? p[kCbOffset] : p[kCrOffset];
        const int qpc = chroma_qp_map(clip3(0, 57, qp_y + off));
        return kTc[clip3(0, 53, qpc + 2 + tc_offset)];
    }

    void deblock_ctb(int cx, int cy) {
        const int size = 1 << pic.ctb_log2;
        const int x0 = cx * size, y0 = cy * size;
        const int x_end = std::min(x0 + size, pic.w), y_end = std::min(y0 + size, pic.h);
        const Slice& cur = slices[pic.slice_of[cy * pic.ctbs_w + cx]];
        const int cur_tc = 2 * cur.tc, cur_beta = 2 * cur.beta;
        int left_tc = 0, left_beta = 0;
        if (x0) {
            const Slice& left = slices[pic.slice_of[cy * pic.ctbs_w + cx - 1]];
            left_tc = 2 * left.tc;
            left_beta = 2 * left.beta;
        }
        int tc_offset = cur_tc, beta_offset = cur_beta;
        const int x_end2 = x_end == pic.w ? x_end : x_end - 8;
        auto luma_pair = [&](int x, int y, bool vertical, int bs0, int bs1, int qp_) {
            const int beta = kBeta[clip3(0, 51, qp_ + beta_offset)];
            const int tc0 = bs0 ? kTc[clip3(0, 53, qp_ + 2 * (bs0 - 1) + (tc_offset & -2))] : 0;
            const int tc1 = bs1 ? kTc[clip3(0, 53, qp_ + 2 * (bs1 - 1) + (tc_offset & -2))] : 0;
            luma(x, y, vertical, beta, tc0);
            luma(vertical ? x : x + 4, vertical ? y + 4 : y, vertical, beta, tc1);
        };
        for (int y = y0; y < y_end; y += 8) {
            for (int x = x0 ? x0 : 8; x < x_end; x += 8) {
                const int bs0 = vbs_at(x, y), bs1 = vbs_at(x, y + 4);
                if (bs0 || bs1) luma_pair(x, y, true, bs0, bs1, (qp(x - 1, y) + qp(x, y) + 1) >> 1);
            }
            if (!y) continue;
            for (int x = x0 ? x0 - 8 : 0; x < x_end2; x += 8) {
                const int bs0 = hbs_at(x, y), bs1 = hbs_at(x + 4, y);
                if (bs0 || bs1) {
                    tc_offset = x >= x0 ? cur_tc : left_tc;
                    beta_offset = x >= x0 ? cur_beta : left_beta;
                    luma_pair(x, y, false, bs0, bs1, (qp(x, y - 1) + qp(x, y) + 1) >> 1);
                }
            }
        }
        const int x_end2c = x_end == pic.w ? x_end : x_end - 16;
        for (int c = 1; c < 3; ++c) {
            for (int y = y0; y < y_end; y += 16) {
                for (int x = x0 ? x0 : 16; x < x_end; x += 16) {
                    const int bs0 = vbs_at(x, y), bs1 = vbs_at(x, y + 8);
                    if (bs0 == 2 || bs1 == 2) {
                        const int q0 = (qp(x - 1, y) + qp(x, y) + 1) >> 1;
                        const int q1 = y + 8 < pic.h ? (qp(x - 1, y + 8) + qp(x, y + 8) + 1) >> 1 : 0;
                        if (bs0 == 2) chroma(c, x, y, true, chroma_tc(q0, c, tc_offset));
                        if (bs1 == 2) chroma(c, x, y + 8, true, chroma_tc(q1, c, tc_offset));
                    }
                }
                if (!y) continue;
                tc_offset = x0 ? left_tc : cur_tc;
                for (int x = x0 ? x0 - 16 : 0; x < x_end2c; x += 16) {
                    const int bs0 = hbs_at(x, y), bs1 = hbs_at(x + 8, y);
                    if (bs0 == 2)
                        chroma(c, x, y, false, chroma_tc((qp(x, y - 1) + qp(x, y) + 1) >> 1, c, tc_offset));
                    if (bs1 == 2)
                        chroma(c, x + 8, y, false,
                               chroma_tc((qp(x + 8, y - 1) + qp(x + 8, y) + 1) >> 1, c, cur_tc));
                }
            }
        }
    }

    // The luma edge of 4 lines at (x, y) (8.7.2.5.3, 8.7.2.5.6, 8.7.2.5.7).
    void luma(int x, int y, bool vertical, int beta, int tc) {
        if (x >= pic.w || y >= pic.h) return;
        const int stride = pic.stride[0];
        const int xp = vertical ? x - 1 : x, yp = vertical ? y : y - 1;
        const bool no_p = no_filter(xp, yp), no_q = no_filter(x, y);
        // Sample k of line l: p side k < 0 (p0 = -1), q side k >= 0.
        const int along = vertical ? stride : 1, across = vertical ? 1 : stride;
        uint8_t* origin = pic.plane[0] + y * stride + x;
        auto s = [&](int l, int k) -> uint8_t& { return origin[l * along + k * across]; };
        auto dp = [&](int l) { return std::abs(s(l, -3) - 2 * s(l, -2) + s(l, -1)); };
        auto dq = [&](int l) { return std::abs(s(l, 2) - 2 * s(l, 1) + s(l, 0)); };
        const int dp0 = dp(0), dp3 = dp(3), dq0 = dq(0), dq3 = dq(3);
        const int dpq0 = dp0 + dq0, dpq3 = dp3 + dq3, d = dpq0 + dpq3;
        if (d >= beta) {
            count(kLfNoChange);
            return;
        }
        auto strong_line = [&](int l, int dpq) {
            return 2 * dpq < (beta >> 2) &&
                   std::abs(s(l, -4) - s(l, -1)) + std::abs(s(l, 0) - s(l, 3)) < (beta >> 3) &&
                   std::abs(s(l, -1) - s(l, 0)) < ((5 * tc + 1) >> 1);
        };
        const bool strong = strong_line(0, dpq0) && strong_line(3, dpq3);
        const int side = (beta + (beta >> 1)) >> 3;
        const bool dep = dp0 + dp3 < side, deq = dq0 + dq3 < side;
        if (no_p || no_q) count(kLfSkippedPcm);
        count(strong ? kLfStrong : kLfNormal);
        for (int l = 0; l < 4; ++l) {
            const int p0 = s(l, -1), p1 = s(l, -2), p2 = s(l, -3), p3 = s(l, -4);
            const int q0 = s(l, 0), q1 = s(l, 1), q2 = s(l, 2), q3 = s(l, 3);
            if (strong) {
                const int t2 = 2 * tc;
                if (!no_p) {
                    s(l, -1) = static_cast<uint8_t>(clip3(p0 - t2, p0 + t2, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3));
                    s(l, -2) = static_cast<uint8_t>(clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2));
                    s(l, -3) = static_cast<uint8_t>(clip3(p2 - t2, p2 + t2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3));
                }
                if (!no_q) {
                    s(l, 0) = static_cast<uint8_t>(clip3(q0 - t2, q0 + t2, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3));
                    s(l, 1) = static_cast<uint8_t>(clip3(q1 - t2, q1 + t2, (p0 + q0 + q1 + q2 + 2) >> 2));
                    s(l, 2) = static_cast<uint8_t>(clip3(q2 - t2, q2 + t2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3));
                }
            } else {
                int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
                if (std::abs(delta) >= tc * 10) continue;
                delta = clip3(-tc, tc, delta);
                if (!no_p) s(l, -1) = static_cast<uint8_t>(clip1(p0 + delta));
                if (!no_q) s(l, 0) = static_cast<uint8_t>(clip1(q0 - delta));
                if (dep && !no_p) {
                    const int dpv = clip3(-(tc >> 1), tc >> 1, (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1);
                    s(l, -2) = static_cast<uint8_t>(clip1(p1 + dpv));
                    count(kLfNormalP1);
                }
                if (deq && !no_q) {
                    const int dqv = clip3(-(tc >> 1), tc >> 1, (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1);
                    s(l, 1) = static_cast<uint8_t>(clip1(q1 + dqv));
                }
            }
        }
    }

    // The chroma edge of 4 chroma lines at luma (x, y) (8.7.2.5.5).
    void chroma(int c, int x, int y, bool vertical, int tc) {
        if (x >= pic.w || y >= pic.h) return;
        const int stride = pic.stride[c];
        const int xp = vertical ? x - 1 : x, yp = vertical ? y : y - 1;
        const bool no_p = no_filter(xp, yp), no_q = no_filter(x, y);
        const int along = vertical ? stride : 1, across = vertical ? 1 : stride;
        uint8_t* origin = pic.plane[c] + (y >> 1) * stride + (x >> 1);
        count(kLfChroma);
        for (int l = 0; l < 4; ++l) {
            uint8_t* o = origin + l * along;
            const int p0 = o[-across], p1 = o[-2 * across], q0 = o[0], q1 = o[across];
            const int delta = clip3(-tc, tc, ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3));
            if (!no_p) o[-across] = static_cast<uint8_t>(clip1(p0 + delta));
            if (!no_q) o[0] = static_cast<uint8_t>(clip1(q0 - delta));
        }
    }

    // SAO (8.7.3) of one CTB on the samples as deblocked so far, into
    // `sao_out`; the planes take the results once every CTB's SAO has read
    // its neighbours. Only the samples on the CTB's border can have a
    // neighbour outside the picture or in another slice.
    void sao_ctb(int rx, int ry) {
        static const int kEo[4][2][2] = {{{-1, 0}, {1, 0}}, {{0, -1}, {0, 1}}, {{-1, -1}, {1, 1}},
                                         {{1, -1}, {-1, 1}}};
        const int addr = ry * pic.ctbs_w + rx;
        const SaoParams& sp = pic.sao[addr];
        const Slice& cur = slices[pic.slice_of[addr]];
        // FFmpeg's restore_tqb_pixels leaves PCM and bypass samples as
        // deblocked only in the luma min PUs from the CTB's corner as far as
        // the component's CTB width and height: for chroma, the CTB's top
        // left quarter.
        const int pu = p[kMinCbLog2] - 1, x0 = rx << pic.ctb_log2, y0 = ry << pic.ctb_log2;
        const int size = 1 << pic.ctb_log2;
        bool any_unfiltered = false;
        for (int y = y0; y < std::min(pic.h, y0 + size) && !any_unfiltered; y += 4)
            for (int x = x0; x < std::min(pic.w, x0 + size); x += 4)
                if (no_filter(x, y)) {
                    any_unfiltered = true;
                    break;
                }
        for (int c = 0; c < 3; ++c) {
            const int type = sp.type[c];
            if (!type) continue;
            sao_done[c][addr] = 1;
            const int sh = c ? 1 : 0, stride = pic.stride[c];
            const int w = pic.w >> sh, h = pic.h >> sh, ctb = size >> sh;
            const uint8_t* src = pic.plane[c];
            uint8_t* out = sao_out[c].data();
            const int xa = rx * ctb, ya = ry * ctb, xb = std::min(w, xa + ctb), yb = std::min(h, ya + ctb);
            const int x_max = (x0 + (xb - xa)) >> pu, y_max = (y0 + (yb - ya)) >> pu;
            int table[32] = {};
            if (type == 1)
                for (int k = 0; k < 4; ++k) table[(k + sp.band[c]) & 31] = k + 1;
            int offset[5];
            for (int k = 0; k < 5; ++k) offset[k] = sp.offset[c][k];
            const int(*eo)[2] = kEo[sp.eo_class[c]];
            const int d0 = eo[0][1] * stride + eo[0][0], d1 = eo[1][1] * stride + eo[1][0];
            for (int y = ya; y < yb; ++y)
                for (int x = xa; x < xb; ++x) {
                    const int at = y * stride + x, v = src[at];
                    out[at] = static_cast<uint8_t>(v);
                    if (any_unfiltered && no_filter(x << sh, y << sh) && ((x << sh) >> pu) < x_max &&
                        ((y << sh) >> pu) < y_max) {
                        count(kSaoSkippedPcm);
                        continue;
                    }
                    int idx;
                    if (type == 1) {
                        idx = table[v >> 3];
                        count(kSaoBand);
                    } else {
                        if (x == xa || x == xb - 1 || y == ya || y == yb - 1) {
                            bool skip = false;
                            for (int k = 0; k < 2 && !skip; ++k) {
                                const int xn = x + eo[k][0], yn = y + eo[k][1];
                                if (xn < 0 || yn < 0 || xn >= w || yn >= h) {
                                    skip = true;
                                    count(kSaoPicEdge);
                                } else if (!cur.across &&
                                           pic.slice_of[pic.ctb_at(xn << sh, yn << sh)] != pic.slice_of[addr]) {
                                    skip = true;
                                    count(kSaoBlockedSlice);
                                }
                            }
                            if (skip) continue;
                        }
                        idx = 2 + sign(v - src[at + d0]) + sign(v - src[at + d1]);
                        idx = idx <= 2 ? (idx == 2 ? 0 : idx + 1) : idx;
                        count(kSaoEdge);
                    }
                    out[at] = static_cast<uint8_t>(clip1(v + offset[idx]));
                }
        }
    }
};

bool valid_params(const int32_t* p) {
    const int ctb = p[kCtbLog2];
    if (p[kMaxDepthInter] < 0 || p[kMaxDepthInter] > ctb - p[kMinTbLog2] || p[kParMrgLevel] < 2 ||
        p[kParMrgLevel] > ctb)
        return false;
    return p[kWidth] > 0 && p[kHeight] > 0 && ctb >= 4 && ctb <= 6 && p[kMinCbLog2] >= 3 &&
           p[kMinCbLog2] <= ctb && p[kMinTbLog2] >= 2 && p[kMinTbLog2] < p[kMinCbLog2] &&
           p[kMaxTbLog2] <= std::min(ctb, 5) && p[kMaxTbLog2] >= p[kMinTbLog2] &&
           p[kWidth] % (1 << p[kMinCbLog2]) == 0 && p[kHeight] % (1 << p[kMinCbLog2]) == 0 &&
           p[kQpDeltaDepth] >= 0 && p[kQpDeltaDepth] <= ctb - p[kMinCbLog2] &&
           (!p[kPcmEnabled] || (p[kPcmBitsY] >= 1 && p[kPcmBitsY] <= 8 && p[kPcmBitsC] >= 1 &&
                                p[kPcmBitsC] <= 8 && p[kPcmMinLog2] >= 3 && p[kPcmMaxLog2] <= std::min(ctb, 5)));
}

// The slices' parameters, or an empty vector when one is out of range
// (`slots`: the reference pictures passed in).
std::vector<Slice> read_slices(int num, const int32_t* sp, int slots) {
    std::vector<Slice> out(num);
    for (int i = 0; i < num; ++i) {
        const int32_t* q = sp + static_cast<size_t>(i) * kSliceInts;
        Slice& s = out[i];
        s.addr = q[kSliceAddr];
        s.qp = q[kSliceQp];
        s.sao_luma = q[kSaoLuma];
        s.sao_chroma = q[kSaoChroma];
        s.cb_offset = q[kSliceCbOffset];
        s.cr_offset = q[kSliceCrOffset];
        s.deblock_off = q[kDeblockOff];
        s.beta = q[kBetaDiv2];
        s.tc = q[kTcDiv2];
        s.across = q[kAcross];
        s.ctbs = q[kSliceCtbs];
        s.type = q[kSliceType];
        s.nref[0] = s.type == kSliceI ? 0 : q[kNumRefL0];
        s.nref[1] = s.type == kSliceB ? q[kNumRefL1] : 0;
        s.mvd_l1_zero = q[kMvdL1Zero];
        s.init_type = q[kInitType];
        s.tmvp = q[kTmvp];
        s.col_from_l0 = q[kColFromL0];
        s.col_ref = q[kColRefIdx];
        s.max_merge = q[kMaxMerge];
        s.weighted = q[kWeighted];
        s.denom[0] = q[kLumaDenom];
        s.denom[1] = q[kChromaDenom];
        if (s.type < 0 || s.type > 2 || s.init_type < 0 || s.init_type > 2 || s.nref[0] < 0 ||
            s.nref[0] > kMaxRefs || s.nref[1] < 0 || s.nref[1] > kMaxRefs ||
            (s.type != kSliceI && (s.nref[0] < 1 || (s.type == kSliceB && s.nref[1] < 1) ||
                                   s.max_merge < 1 || s.max_merge > 5 || s.denom[0] < 0 || s.denom[0] > 7 ||
                                   s.denom[1] < 0 || s.denom[1] > 7)))
            return {};
        for (int l = 0; l < 2; ++l)
            for (int k = 0; k < kMaxRefs; ++k) {
                const int32_t* r = q + kSliceRefs + (l * kMaxRefs + k) * kRefInts;
                RefEntry& e = s.ref[l][k];
                e = RefEntry{r[0], r[1], r[2], {r[3], r[5], r[7]}, {r[4], r[6], r[8]}};
                if (k < s.nref[l] && (e.slot < 0 || e.slot >= slots)) return {};
            }
        if (s.type != kSliceI && s.tmvp &&
            (s.col_ref < 0 || s.col_ref >= s.nref[s.col_from_l0 ? 0 : 1]))
            return {};
    }
    return out;
}

// NoBackwardPredFlag of each slice (8.5.3.2.9): no reference picture after
// the current one.
void set_no_backward(std::vector<Slice>& slices, int poc) {
    for (Slice& s : slices) {
        s.no_backward = true;
        for (int l = 0; l < 2; ++l)
            for (int k = 0; k < s.nref[l]; ++k) s.no_backward &= s.ref[l][k].poc <= poc;
    }
}

// The picture's motion field for the temporal candidates of later pictures
// (ColField), each 16x16 block's top-left 4x4 block's.
void export_field(const Picture& pic, const std::vector<Slice>& slices, int32_t* field) {
    const int w16 = (pic.w + 15) >> 4, h16 = (pic.h + 15) >> 4;
    for (int y = 0; y < h16; ++y)
        for (int x = 0; x < w16; ++x) {
            const Mvf& m = pic.mvf[pic.at4(x << 4, y << 4)];
            const Slice& s = slices[pic.slice_of[pic.ctb_at(x << 4, y << 4)]];
            int32_t* f = field + (static_cast<size_t>(y) * w16 + x) * kColInts;
            for (int k = 0; k < kColInts; ++k) f[k] = 0;
            f[kColFlags] = m.pf;
            for (int l = 0; l < 2; ++l) {
                if (!(m.pf >> l & 1)) continue;
                f[kColMv0x + 2 * l] = m.mv[l].x;
                f[kColMv0y + 2 * l] = m.mv[l].y;
                f[kColPoc0 + l] = s.ref[l][m.ref[l]].poc;
                f[kColLt0 + l] = s.ref[l][m.ref[l]].lt;
            }
        }
}

}  // namespace

extern "C" {

int hive_hevc_param_ints() { return kParamInts; }
int hive_hevc_slice_ints() { return kSliceInts; }

int hive_hevc_stat_counts(int32_t* named, int32_t* filter_stats) {
    *named = kStatNamed;
    *filter_stats = kLfStats;
    return kStatTotal;
}

int hive_hevc_col_ints() { return kColInts; }

// Decode one picture's slice segments (each slice's RBSP from the byte
// after its header, kPadding zero bytes after its end) into the coded
// planes, then deblock and apply SAO. P and B slices read the `slots`
// reference pictures' planes (`refs`, three a slot) and the collocated
// picture's motion field (`col`, may be null); `field` (may be null)
// receives this picture's. `filter_stats` (kLfStats, may be null) counts
// the loop filters' decisions. Returns 0, or a Status.
int hive_hevc_decode_picture(const int32_t* params, int num_slices, const int32_t* slice_params,
                             const uint8_t* const* data, const int64_t* sizes, uint8_t* const* planes,
                             const uint8_t* const* refs, int slots, const int32_t* col, int32_t* field,
                             int64_t* filter_stats) {
    if (!valid_params(params) || num_slices < 1) return kErrArgs;
    Picture pic(params, planes);
    std::vector<Slice> slices = read_slices(num_slices, slice_params, refs ? slots : 0);
    if (slices.empty()) return kErrArgs;
    set_no_backward(slices, params[kPoc]);
    const int total = pic.ctbs_w * pic.ctbs_h;
    std::vector<uint8_t> decoded(total, 0);
    for (int k = 0; k < num_slices; ++k) {
        const Slice& s = slices[k];
        if (s.addr < 0 || s.addr >= total || decoded[s.addr]) return kErrArgs;
        Reader r{data[k], sizes[k] * 8, 0};
        Coder<cabac::Decoder<Reader>> cd(pic, params, s, k);
        if (s.type != kSliceI && s.tmvp && !col) return kErrArgs;
        cd.refs = refs;
        cd.col = s.tmvp ? col : nullptr;
        cd.e.r = &r;
        cd.e.limit = sizes[k] * 8 + 8 * 8;
        cd.init_contexts();
        cd.e.start();
        int ctb = s.addr;
        while (true) {
            if (ctb >= total || decoded[ctb]) return kErrPastEnd;
            decoded[ctb] = 1;
            pic.slice_of[ctb] = k;
            const int rx = ctb % pic.ctbs_w, ry = ctb / pic.ctbs_w;
            if (s.sao_luma || s.sao_chroma) cd.sao(rx, ry, nullptr);
            cd.quadtree(rx << pic.ctb_log2, ry << pic.ctb_log2, pic.ctb_log2, 0);
            if (cd.status) return cd.status;
            if (cd.e.over) return kErrOverrun;
            const int end = cd.e.terminate(0);
            ++ctb;
            if (end) break;
        }
    }
    for (int k = 0; k < total; ++k)
        if (!decoded[k]) return kErrShort;
    if (field) export_field(pic, slices, field);
    if (filter_stats)
        LoopFilter<true>{pic, params, slices, filter_stats, {}, {}, {}, {}}.run();
    else
        LoopFilter<false>{pic, params, slices, nullptr, {}, {}, {}, {}}.run();
    return kOk;
}

// Encode one picture: for each slice, its header bytes (NAL header and
// slice segment header, byte_alignment() included) then its CTUs as the
// plan (`knobs`, seeded by `seed`) chooses them; the RBSPs go to `out`
// (capacity bytes) back to back, their sizes to `sizes`. `recon` receives
// the reconstruction before the loop filters. `stats` (kStatTotal) counts
// the paths and contexts written. `sao` gives each CTB's SAO parameters
// (type[c] -1 / -2 for a merge left / up). P and B slices read `refs`,
// `slots` and `col` as the decoder does. Returns the bytes written, or a
// Status.
int64_t hive_hevc_encode_picture(const int32_t* params, int num_slices, const int32_t* slice_params,
                                 const int32_t* knobs, uint64_t seed, const uint8_t* const* source,
                                 uint8_t* const* recon, const uint8_t* const* headers,
                                 const int64_t* header_bytes, const int8_t* sao, uint8_t* out,
                                 int64_t capacity, int64_t* sizes, int64_t* stats,
                                 const uint8_t* const* refs, int slots, const int32_t* col) {
    if (!valid_params(params) || num_slices < 1) return kErrArgs;
    Picture pic(params, recon);
    std::vector<Slice> slices = read_slices(num_slices, slice_params, refs ? slots : 0);
    if (slices.empty()) return kErrArgs;
    set_no_backward(slices, params[kPoc]);
    const int total = pic.ctbs_w * pic.ctbs_h;
    Rng rng{seed};
    int64_t written = 0;
    int next = 0;
    for (int k = 0; k < num_slices; ++k) {
        const Slice& s = slices[k];
        if (s.addr != next || s.ctbs < 1 || s.addr + s.ctbs > total) return kErrArgs;
        next = s.addr + s.ctbs;
        Writer w;
        w.bytes.assign(headers[k], headers[k] + header_bytes[k]);
        Coder<cabac::Encoder<Writer>> cd(pic, params, s, k);
        if (s.type != kSliceI && s.tmvp && !col) return kErrArgs;
        cd.refs = refs;
        cd.col = s.tmvp ? col : nullptr;
        cd.e.w = &w;
        cd.e.cover = stats + kStatContexts + s.init_type * kNumContexts;
        cd.stats = stats;
        cd.rec.stats = stats;
        cd.src = source;
        cd.knobs = knobs;
        cd.rng = &rng;
        cd.init_contexts();
        cd.e.start();
        for (int ctb = s.addr; ctb < s.addr + s.ctbs; ++ctb) {
            pic.slice_of[ctb] = k;
            const int rx = ctb % pic.ctbs_w, ry = ctb / pic.ctbs_w;
            if (s.sao_luma || s.sao_chroma) {
                SaoParams want{};
                const int8_t* q = sao + static_cast<size_t>(ctb) * 24;
                for (int c = 0; c < 3; ++c) {
                    want.type[c] = q[c];
                    want.eo_class[c] = q[3 + c];
                    want.band[c] = q[6 + c];
                    for (int i = 0; i < 4; ++i) want.offset[c][i + 1] = q[9 + 4 * c + i];
                }
                if ((want.type[0] == -1 && !(rx > 0 && ctb - 1 >= s.addr)) ||
                    (want.type[0] == -2 && !(ry > 0 && ctb - pic.ctbs_w >= s.addr)))
                    return kErrArgs;   // a merge the syntax cannot code
                cd.sao(rx, ry, &want);
            }
            cd.quadtree(rx << pic.ctb_log2, ry << pic.ctb_log2, pic.ctb_log2, 0);
            if (cd.status) return cd.status;
            cd.e.terminate(ctb == s.addr + s.ctbs - 1);
        }
        w.align_zero();
        if (written + static_cast<int64_t>(w.bytes.size()) > capacity) return kErrCapacity;
        std::memcpy(out + written, w.bytes.data(), w.bytes.size());
        sizes[k] = static_cast<int64_t>(w.bytes.size());
        written += sizes[k];
    }
    if (next != total) return kErrArgs;
    return written;
}

}  // extern "C"
