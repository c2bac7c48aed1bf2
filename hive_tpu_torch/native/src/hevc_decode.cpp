// HEVC (ITU-T H.265 | ISO/IEC 23008-2) Main profile intra pictures, both
// ways: one picture's slice segments decoded below their headers as the
// standard specifies (and so as FFmpeg's hevc decoder, and cv2.VideoCapture,
// decode them), its deblocking and sample adaptive offset, and the matching
// encode, which writes the test fixtures.
//
// The Python side (hive_tpu_torch/video/hevc.py) parses the parameter sets
// and slice segment headers, refuses what this file does not decode (P and
// B slices, scaling lists, tiles, WPP, dependent slice segments, depths above
// 8 bits, chroma other than 4:2:0), and hands hive_hevc_decode_picture each
// slice's RBSP from the byte after its header. Per coding tree unit: sao()
// with its merges; the coding quadtree (split_cu_flag's context from the
// neighbours' depths); each coding unit's cu_transquant_bypass_flag,
// part_mode (2Nx2N / NxN at the smallest coding block), pcm_flag and its
// samples, the luma modes by their most probable mode list (8.4.2) and the
// chroma mode (mode 4: the luma mode; a mode equal to the luma one becomes
// 34); the transform tree (split_transform_flag, cbf_cb / cbf_cr / cbf_luma,
// the 4x4 luma blocks' chroma coded with the fourth), cu_qp_delta with the
// quantisation group's prediction (8.6.1), and residual_coding (9.3.4.2):
// the last position, coded sub-blocks, the diagonal, horizontal and
// vertical scans (by intra mode for 4x4 blocks and 8x8 luma), sig_coeff_flag,
// greater1 / greater2 with their context sets, sign data hiding,
// coeff_abs_level_remaining with its Rice parameter, transform_skip_flag.
// Reconstruction: flat dequantisation and the chroma QP table, the 4x4 DST
// of intra luma, the DCT from 4 to 32 (clipped to 16 bits between its
// stages), transform skip and transquant bypass; intra sample prediction
// (8.4.4.2): reference sample availability in z-scan order and by slice,
// substitution, the [1 2 1] filter and strong intra smoothing, planar, DC,
// the 33 angles with the inverse-angle projection, the DC / horizontal /
// vertical edge filters of luma below 32x32. Then the picture's deblocking
// (8.7.2: transform and coding block edges on the 8x8 grid, bS 2, the strong
// and normal luma filters, chroma on its 8x8 grid, each slice's disable flag,
// offsets and slice_loop_filter_across_slices_enabled_flag, PCM with
// pcm_loop_filter_disabled_flag and transquant bypass left alone) and SAO
// (8.7.3: band offset and the four edge classes on the deblocked picture),
// both run CTB by CTB in the order of FFmpeg's decoder, whose departures
// from the standard cv2's frames carry (LoopFilter).
//
// The encoder (hive_hevc_encode_picture) codes the same syntax through the
// same functions with cabac::Encoder: a plan decides each choice (seeded
// choices of every path above, or the best intra mode for a real picture),
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
    kQpDeltaDepth, kCbOffset, kCrOffset, kBypassEnabled, kParamInts
};

enum SliceParam {
    kSliceAddr, kSliceQp, kSaoLuma, kSaoChroma, kSliceCbOffset, kSliceCrOffset, kDeblockOff,
    kBetaDiv2, kTcDiv2, kAcross, kSliceCtbs, kSliceInts
};

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

struct Slice {
    int addr, qp, sao_luma, sao_chroma, cb_offset, cr_offset, deblock_off, beta, tc, across;
    int ctbs;   // the encoder's count of CTUs; the decoder reads end_of_slice_segment_flag
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
    kStatNamed,
    kStatContexts = kStatNamed,
    kStatTotal = kStatNamed + kNumContexts,
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

struct Picture {
    int w, h, ctb_log2, ctbs_w, ctbs_h, w4, h4;
    uint8_t* plane[3];
    int stride[3];
    std::vector<uint8_t> ipm, depth, flags;
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
    void fill4(std::vector<T>& a, int x0, int y0, int size, T v) {
        const int n = std::max(1, size >> 2);
        for (int j = 0; j < n && (y0 >> 2) + j < h4; ++j)
            for (int i = 0; i < n && (x0 >> 2) + i < w4; ++i) a[at4(x0, y0) + j * w4 + i] = v;
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

struct CuPlan {
    int bypass, nxn, pcm, chroma_mode;
    int modes[4];
    int qp_delta;               // coded when a transform unit has a coefficient
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
    kKnobBest,           // 1: the best intra mode by SAD (a real picture), 0: seeded
    kKnobSplitCu, kKnobBypass, kKnobPcm, kKnobNxN, kKnobSplitTu, kKnobTs, kKnobQpDelta,
    kKnobDeadZone, kKnobChroma4, kKnobMaxLevel,
    kKnobInts
};

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

    int min_cb, min_tb, max_tb, qg_log2;
    // Quantisation group state (8.6.1).
    int qp_prev, qp_pred = 0, qp_y, qp_delta_val = 0;
    bool qp_delta_coded = false;
    int cu_chroma_mode = 1, cu_bypass = 0;
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

    void init_contexts() {
        const int qp = clip3(0, 51, s.qp);
        for (int k = 0; k < kNumContexts; ++k) {
            const int m = (kInitValues[k] >> 4) * 5 - 45, n = ((kInitValues[k] & 15) << 3) - 16;
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
            split = bin(kCtxSplitCu + inc, kEnc ? rng->chance(knobs[kKnobSplitCu]) : 0);
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
        int nxn = 0;
        if (log2 == min_cb) nxn = !bin(kCtxPartMode, kEnc ? !plan.nxn : 0);
        int pcm = 0;
        if (!nxn && p[kPcmEnabled] && log2 >= p[kPcmMinLog2] && log2 <= p[kPcmMaxLog2])
            pcm = e.terminate(kEnc ? plan.pcm : 0);
        if (kEnc) {
            stats[kStatBypass] += cu_bypass;
            stats[kStatNxN] += nxn;
        }
        uint8_t cu_flags = 0;
        if (pcm) cu_flags |= kFlagPcm | (p[kPcmNoFilter] ? kFlagNoFilter : 0);
        if (cu_bypass) cu_flags |= kFlagNoFilter;
        pic.fill4(pic.flags, x0, y0, size, cu_flags);
        pic.mark_edges(x0, y0, size);
        if (pcm) {
            pcm_samples(x0, y0, log2);
            pic.fill4(pic.ipm, x0, y0, size, uint8_t(1));
        } else {
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
            transform_tree(x0, y0, x0, y0, log2, 0, 0, nxn, p[kMaxDepthIntra] + nxn, 0, 0);
        }
        pic.fill4(pic.qp, x0, y0, size, static_cast<int8_t>(qp_y));
        qp_prev = qp_y;
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
        if (log2 <= max_tb && log2 > min_tb && depth < max_depth && !(intra_split && depth == 0))
            split = bin(kCtxSplitTf + 5 - log2, kEnc ? node->split : 0);
        else
            split = log2 > max_tb || (intra_split && depth == 0);
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
        const int luma = bin(kCtxCbfLuma + (depth == 0), kEnc ? node->cbf_luma : 0);
        transform_unit(x0, y0, xb, yb, log2, blk, luma, cb, cr, node);
    }

    int chroma_qp(int c) const {
        const int off = c == 1 ? p[kCbOffset] + s.cb_offset : p[kCrOffset] + s.cr_offset;
        return chroma_qp_map(clip3(0, 57, qp_y + off));
    }

    void transform_unit(int x0, int y0, int xb, int yb, int log2, int blk, int luma, int cb, int cr,
                        const TuNode* node) {
        const int mode = pic.ipm[pic.at4(x0, y0)];
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
        rec.predict(0, x0, y0, log2, mode);
        if (luma) block(0, x0, y0, log2, mode, node);
        if (log2 > 2) {
            rec.predict(1, x0 >> 1, y0 >> 1, log2 - 1, cu_chroma_mode);
            if (cb) block(1, x0 >> 1, y0 >> 1, log2 - 1, cu_chroma_mode, node);
            rec.predict(2, x0 >> 1, y0 >> 1, log2 - 1, cu_chroma_mode);
            if (cr) block(2, x0 >> 1, y0 >> 1, log2 - 1, cu_chroma_mode, node);
        } else if (blk == 3) {
            if (kEnc) ++stats[kStatChromaTb4At3];
            rec.predict(1, xb >> 1, yb >> 1, 2, cu_chroma_mode);
            if (cb) block(1, xb >> 1, yb >> 1, 2, cu_chroma_mode, node);
            rec.predict(2, xb >> 1, yb >> 1, 2, cu_chroma_mode);
            if (cr) block(2, xb >> 1, yb >> 1, 2, cu_chroma_mode, node);
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
        residual(level, log2, qp, c == 0 && log2 == 2, ts, cu_bypass, res, kEnc ? stats : nullptr);
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
    plan.nxn = log2 == min_cb && log2 > min_tb && rng->chance(knobs[kKnobNxN]);
    plan.pcm = !plan.nxn && p[kPcmEnabled] && log2 >= p[kPcmMinLog2] && log2 <= p[kPcmMaxLog2] &&
               rng->chance(knobs[kKnobPcm]);
    if (plan.pcm) return;
    const int range = knobs[kKnobQpDelta];
    plan.qp_delta = qp_delta_coded ? qp_delta_val : 0;
    if (!qp_delta_coded && range) {
        // Keep the QP at or above 0 and at most 51 without the wrap.
        const int lo = std::max({-range, -qp_pred, -26}), hi = std::min({range, 51 - qp_pred, 25});
        plan.qp_delta = lo + rng->below(hi - lo + 1);
    }
    const int qp = wrap_qp(qp_pred + plan.qp_delta);
    const int parts = plan.nxn ? 4 : 1, pb = (1 << log2) >> plan.nxn;
    for (int i = 0; i < parts; ++i) {
        const int xp = x0 + (i & 1) * pb, yp = y0 + (i >> 1) * pb;
        plan.modes[i] = best ? best_mode(xp, yp, std::min(5, log2 - plan.nxn)) : rng->below(35);
    }
    plan.chroma_mode = best ? 4 : (rng->chance(knobs[kKnobChroma4]) ? 4 : rng->below(4));
    static const int kChromaModes[4] = {0, 26, 10, 1};
    cu_chroma_mode = plan.chroma_mode == 4 ? plan.modes[0] : kChromaModes[plan.chroma_mode];
    if (plan.chroma_mode != 4 && cu_chroma_mode == plan.modes[0]) cu_chroma_mode = 34;
    cu_bypass = plan.bypass;
    // The modes as the prediction reads them.
    for (int i = 0; i < parts; ++i)
        pic.fill4(pic.ipm, x0 + (i & 1) * pb, y0 + (i >> 1) * pb, pb, static_cast<uint8_t>(plan.modes[i]));
    const int saved_qp = qp_y;
    qp_y = qp;
    plan_tree(x0, y0, x0, y0, log2, 0, 0, plan.nxn, p[kMaxDepthIntra] + plan.nxn, qp, plan.modes);
    qp_y = saved_qp;
    plan.cursor = 0;
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
        split = log2 > max_tb || (intra_split && depth == 0);
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
    const int mode = pic.ipm[pic.at4(x0, y0)];
    pic.mark_edges(x0, y0, 1 << log2);
    node.cbf_luma = static_cast<int8_t>(plan_block(0, x0, y0, log2, mode, qp, plan.nodes[at]));
    if (log2 > 2) {
        plan_block(1, x0 >> 1, y0 >> 1, log2 - 1, cu_chroma_mode, qp, plan.nodes[at]);
        plan_block(2, x0 >> 1, y0 >> 1, log2 - 1, cu_chroma_mode, qp, plan.nodes[at]);
    } else if (blk == 3) {
        // The 8x8 node's chroma, coded with its fourth 4x4 luma block: its
        // flags belong to the parent node (the cbf of a log2 2 node is the
        // parent's).
        TuNode& parent = plan.nodes[at - 4];
        plan_block(1, xb >> 1, yb >> 1, 2, cu_chroma_mode, qp, parent);
        plan_block(2, xb >> 1, yb >> 1, 2, cu_chroma_mode, qp, parent);
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
    rec.predict(c, xc, yc, log2, mode);
    const uint8_t* pred = pic.plane[c] + yc * stride + xc;
    const uint8_t* target = src[c] + yc * stride + xc;
    int32_t diff[32 * 32], level[32 * 32], res[32 * 32];
    for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) diff[y * n + x] = target[y * stride + x] - pred[y * stride + x];
    const int qp = c ? chroma_qp_map(clip3(0, 57, qp_luma + (c == 1 ? p[kCbOffset] + s.cb_offset
                                                                      : p[kCrOffset] + s.cr_offset)))
                     : qp_luma;
    const bool dst = c == 0 && log2 == 2;
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
    // segment at (x, y) on the 8x8 grid: 2 for a transform or coding block
    // edge (every block is intra), 0 elsewhere.
    int bs(int x, int y, bool vertical) const {
        if (vertical ? (x == 0 || (x & 7)) : (y == 0 || (y & 7))) return 0;
        if (!(pic.flags[pic.at4(x, y)] & (vertical ? kFlagEdgeV : kFlagEdgeH))) return 0;
        const Slice& q = slice_at(x, y);
        if (q.deblock_off) return 0;
        const int xp = vertical ? x - 1 : x, yp = vertical ? y : y - 1;
        if (!q.across && pic.slice_of[pic.ctb_at(xp, yp)] != pic.slice_of[pic.ctb_at(x, y)]) {
            count(kLfSkippedEdge);
            return 0;
        }
        return 2;
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
    return p[kWidth] > 0 && p[kHeight] > 0 && ctb >= 4 && ctb <= 6 && p[kMinCbLog2] >= 3 &&
           p[kMinCbLog2] <= ctb && p[kMinTbLog2] >= 2 && p[kMinTbLog2] < p[kMinCbLog2] &&
           p[kMaxTbLog2] <= std::min(ctb, 5) && p[kMaxTbLog2] >= p[kMinTbLog2] &&
           p[kWidth] % (1 << p[kMinCbLog2]) == 0 && p[kHeight] % (1 << p[kMinCbLog2]) == 0 &&
           p[kQpDeltaDepth] >= 0 && p[kQpDeltaDepth] <= ctb - p[kMinCbLog2] &&
           (!p[kPcmEnabled] || (p[kPcmBitsY] >= 1 && p[kPcmBitsY] <= 8 && p[kPcmBitsC] >= 1 &&
                                p[kPcmBitsC] <= 8 && p[kPcmMinLog2] >= 3 && p[kPcmMaxLog2] <= std::min(ctb, 5)));
}

std::vector<Slice> read_slices(int num, const int32_t* sp) {
    std::vector<Slice> out(num);
    for (int i = 0; i < num; ++i) {
        const int32_t* q = sp + i * kSliceInts;
        out[i] = Slice{q[kSliceAddr], q[kSliceQp], q[kSaoLuma], q[kSaoChroma], q[kSliceCbOffset],
                       q[kSliceCrOffset], q[kDeblockOff], q[kBetaDiv2], q[kTcDiv2], q[kAcross], q[kSliceCtbs]};
    }
    return out;
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

// Decode one picture's slice segments (each slice's RBSP from the byte
// after its header, kPadding zero bytes after its end) into the coded
// planes, then deblock and apply SAO. `filter_stats` (kLfStats, may be
// null) counts the loop filters' decisions. Returns 0, or a Status.
int hive_hevc_decode_picture(const int32_t* params, int num_slices, const int32_t* slice_params,
                             const uint8_t* const* data, const int64_t* sizes, uint8_t* const* planes,
                             int64_t* filter_stats) {
    if (!valid_params(params) || num_slices < 1) return kErrArgs;
    Picture pic(params, planes);
    const std::vector<Slice> slices = read_slices(num_slices, slice_params);
    const int total = pic.ctbs_w * pic.ctbs_h;
    std::vector<uint8_t> decoded(total, 0);
    for (int k = 0; k < num_slices; ++k) {
        const Slice& s = slices[k];
        if (s.addr < 0 || s.addr >= total || decoded[s.addr]) return kErrArgs;
        Reader r{data[k], sizes[k] * 8, 0};
        Coder<cabac::Decoder<Reader>> cd(pic, params, s, k);
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
// (type[c] -1 / -2 for a merge left / up). Returns the bytes written, or a
// Status.
int64_t hive_hevc_encode_picture(const int32_t* params, int num_slices, const int32_t* slice_params,
                                 const int32_t* knobs, uint64_t seed, const uint8_t* const* source,
                                 uint8_t* const* recon, const uint8_t* const* headers,
                                 const int64_t* header_bytes, const int8_t* sao, uint8_t* out,
                                 int64_t capacity, int64_t* sizes, int64_t* stats) {
    if (!valid_params(params) || num_slices < 1) return kErrArgs;
    Picture pic(params, recon);
    const std::vector<Slice> slices = read_slices(num_slices, slice_params);
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
        cd.e.w = &w;
        cd.e.cover = stats + kStatContexts;
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
