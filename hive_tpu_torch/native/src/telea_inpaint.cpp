// Telea's fast-marching inpainting, as OpenCV's cv::inpaint(...,
// INPAINT_TELEA) computes it (modules/photo/src/inpaint.cpp), for 8-bit
// 1- and 3-channel and 16-bit 1-channel images.
//
// The structure follows OpenCV's step for step, so that the result is the
// same to the bit:
//   * every map is padded with a one-pixel frame that is never inpainted;
//   * a first fast march runs outwards from the hole's boundary over the
//     ring of width `range` around it, and stores those distances negated;
//   * the second march runs inwards through the hole; each pixel it reaches
//     is filled from the known pixels within `range` with Telea's weights
//     dst * lev * dir, and its channels are filled independently in one
//     march order;
//   * the march pops the smallest distance first and breaks ties in the
//     order of insertion (OpenCV keeps a sorted list; a heap keyed on
//     (T, insertion number) pops the same sequence);
//   * accumulators are float, the final value saturate_cast of
//     Ia / s + (Jx + Jy) / (sqrt(Jx^2 + Jy^2) + 1e-20) + 0.5, all in float;
//   * the weights round as OpenCV's build rounds them: `lev` divides in
//     double, and `dst` takes a double square root for 3-channel images and
//     a float one for 1-channel images (the two loops differ there).
// Build with -ffp-contract=off: a fused multiply-add would round the sums
// differently from OpenCV's build.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

constexpr uint8_t KNOWN = 0;
constexpr uint8_t BAND = 1;
constexpr uint8_t INSIDE = 2;
constexpr uint8_t CHANGE = 3;

struct Entry {
    float t;
    int64_t order;
    int i, j;
};

struct Later {
    bool operator()(const Entry& a, const Entry& b) const {
        return a.t > b.t || (a.t == b.t && a.order > b.order);
    }
};

class MarchQueue {
public:
    void push(int i, int j, float t) { heap_.push(Entry{t, next_++, i, j}); }

    bool pop(int* i, int* j) {
        if (heap_.empty()) {
            return false;
        }
        *i = heap_.top().i;
        *j = heap_.top().j;
        heap_.pop();
        return true;
    }

private:
    std::priority_queue<Entry, std::vector<Entry>, Later> heap_;
    int64_t next_ = 0;
};

inline float min4(float a, float b, float c, float d) {
    a = a < b ? a : b;
    c = c < d ? c : d;
    return a < c ? a : c;
}

float solve(int i1, int j1, int i2, int j2, const std::vector<uint8_t>& f,
            const std::vector<float>& t, int cols) {
    const double a11 = t[(size_t)i1 * cols + j1];
    const double a22 = t[(size_t)i2 * cols + j2];
    const double m12 = a11 < a22 ? a11 : a22;
    double sol;

    if (f[(size_t)i1 * cols + j1] != INSIDE) {
        if (f[(size_t)i2 * cols + j2] != INSIDE) {
            if (std::fabs(a11 - a22) >= 1.0) {
                sol = 1 + m12;
            } else {
                sol = (a11 + a22 + std::sqrt((double)(2 - (a11 - a22) * (a11 - a22)))) * 0.5;
            }
        } else {
            sol = 1 + a11;
        }
    } else if (f[(size_t)i2 * cols + j2] != INSIDE) {
        sol = 1 + a22;
    } else {
        sol = 1 + m12;
    }
    return (float)sol;
}

float solve_at(int i, int j, const std::vector<uint8_t>& f, const std::vector<float>& t,
               int cols) {
    return min4(solve(i - 1, j, i, j - 1, f, t, cols), solve(i + 1, j, i, j - 1, f, t, cols),
                solve(i - 1, j, i, j + 1, f, t, cols), solve(i + 1, j, i, j + 1, f, t, cols));
}

const int DI[4] = {-1, 0, 1, 0};
const int DJ[4] = {0, -1, 0, 1};

// The outward march over the ring (`f` is the ring's flag map): distances
// grow from the hole's boundary and are stored negated.
void march_outside(std::vector<uint8_t>& f, std::vector<float>& t, int rows, int cols,
                   MarchQueue& queue) {
    int ii, jj;
    while (queue.pop(&ii, &jj)) {
        f[(size_t)ii * cols + jj] = CHANGE;
        for (int q = 0; q < 4; q++) {
            const int i = ii + DI[q], j = jj + DJ[q];
            if (i <= 0 || j <= 0 || i > rows - 1 || j > cols - 1) {
                continue;
            }
            if (f[(size_t)i * cols + j] == INSIDE) {
                const float d = solve_at(i, j, f, t, cols);
                t[(size_t)i * cols + j] = d;
                f[(size_t)i * cols + j] = BAND;
                queue.push(i, j, d);
            }
        }
    }
    for (size_t k = 0; k < f.size(); k++) {
        if (f[k] == CHANGE) {
            f[k] = KNOWN;
            t[k] = -t[k];
        }
    }
}

template <typename T>
inline T saturate(float v) {
    // saturate_cast<T>(float): round half to even, then clamp.
    const int iv = (int)std::nearbyint(v);
    const int hi = (int)(T)~(T)0;
    return (T)(iv < 0 ? 0 : (iv > hi ? hi : iv));
}

// The inward march: fills `out` (rows - 2, cols - 2, channels) in place.
template <typename T>
void march_inside(std::vector<uint8_t>& f, std::vector<float>& t, int rows, int cols,
                  T* out, int channels, int range, MarchQueue& queue) {
    const int ocols = cols - 2;
    auto px = [&](int y, int x, int c) -> float {
        return (float)out[((size_t)y * ocols + x) * channels + c];
    };
    auto flag = [&](int y, int x) -> uint8_t { return f[(size_t)y * cols + x]; };
    auto tt = [&](int y, int x) -> float { return t[(size_t)y * cols + x]; };

    int ii, jj;
    while (queue.pop(&ii, &jj)) {
        f[(size_t)ii * cols + jj] = KNOWN;
        for (int q = 0; q < 4; q++) {
            const int i = ii + DI[q], j = jj + DJ[q];
            if (i <= 0 || j <= 0 || i > rows - 1 || j > cols - 1) {
                continue;
            }
            if (flag(i, j) != INSIDE) {
                continue;
            }
            const float d = solve_at(i, j, f, t, cols);
            t[(size_t)i * cols + j] = d;

            for (int color = 0; color < channels; color++) {
                float gtx, gty;
                if (flag(i, j + 1) != INSIDE) {
                    gtx = flag(i, j - 1) != INSIDE ? (tt(i, j + 1) - tt(i, j - 1)) * 0.5f
                                                   : tt(i, j + 1) - tt(i, j);
                } else {
                    gtx = flag(i, j - 1) != INSIDE ? tt(i, j) - tt(i, j - 1) : 0.0f;
                }
                if (flag(i + 1, j) != INSIDE) {
                    gty = flag(i - 1, j) != INSIDE ? (tt(i + 1, j) - tt(i - 1, j)) * 0.5f
                                                   : tt(i + 1, j) - tt(i, j);
                } else {
                    gty = flag(i - 1, j) != INSIDE ? tt(i, j) - tt(i - 1, j) : 0.0f;
                }

                float Ia = 0, Jx = 0, Jy = 0, s = 1.0e-20f;
                for (int k = i - range; k <= i + range; k++) {
                    // k - 1 is the image row of k; OpenCV's gradients read
                    // edge-clamped rows and columns (km, kp, lm, lp), its
                    // value term the pixel itself. The central differences
                    // are doubled (x2, not x0.5), as OpenCV's are.
                    const int km = k - 1 + (k == 1), kp = k - 1 - (k == rows - 2);
                    for (int l = j - range; l <= j + range; l++) {
                        const int lm = l - 1 + (l == 1), lp = l - 1 - (l == cols - 2);
                        if (!(k > 0 && l > 0 && k < rows - 1 && l < cols - 1)) {
                            continue;
                        }
                        if (flag(k, l) == INSIDE ||
                            (l - j) * (l - j) + (k - i) * (k - i) > range * range) {
                            continue;
                        }
                        const float ry = (float)(i - k), rx = (float)(j - l);
                        const float len2 = rx * rx + ry * ry;
                        const float dst = channels == 3
                                              ? (float)(1. / (len2 * std::sqrt((double)len2)))
                                              : (float)(1. / (len2 * std::sqrt(len2)));
                        const float lev =
                            (float)(1. / (1 + std::fabs((double)(tt(k, l) - tt(i, j)))));
                        float dir = rx * gtx + ry * gty;
                        if (std::fabs(dir) <= 0.01) {
                            dir = 0.000001f;
                        }
                        const float w = (float)std::fabs(dst * lev * dir);

                        float gix, giy;
                        if (flag(k, l + 1) != INSIDE) {
                            gix = flag(k, l - 1) != INSIDE
                                      ? (px(km, lp + 1, color) - px(km, lm - 1, color)) * 2.0f
                                      : px(km, lp + 1, color) - px(km, lm, color);
                        } else {
                            gix = flag(k, l - 1) != INSIDE
                                      ? px(km, lp, color) - px(km, lm - 1, color)
                                      : 0.0f;
                        }
                        if (flag(k + 1, l) != INSIDE) {
                            giy = flag(k - 1, l) != INSIDE
                                      ? (px(kp + 1, lm, color) - px(km - 1, lm, color)) * 2.0f
                                      : px(kp + 1, lm, color) - px(km, lm, color);
                        } else {
                            giy = flag(k - 1, l) != INSIDE
                                      ? px(kp, lm, color) - px(km - 1, lm, color)
                                      : 0.0f;
                        }
                        Ia += w * px(k - 1, l - 1, color);
                        Jx -= w * (gix * rx);
                        Jy -= w * (giy * ry);
                        s += w;
                    }
                }
                const float sat =
                    (float)(Ia / s + (Jx + Jy) / (std::sqrt(Jx * Jx + Jy * Jy) + 1.0e-20f) + 0.5f);
                out[((size_t)(i - 1) * ocols + (j - 1)) * channels + color] = saturate<T>(sat);
            }
            f[(size_t)i * cols + j] = BAND;
            queue.push(i, j, d);
        }
    }
}

// Dilation of a padded 0/value map by a (2r+1) square (r = 1 with `cross`
// for the 3x3 cross); pixels outside the map are ignored.
std::vector<uint8_t> dilate(const std::vector<uint8_t>& src, int rows, int cols, int r,
                            bool cross) {
    std::vector<uint8_t> tmp(src.size()), dst(src.size());
    if (cross) {
        for (int i = 0; i < rows; i++) {
            for (int j = 0; j < cols; j++) {
                uint8_t v = src[(size_t)i * cols + j];
                if (i > 0) v = std::max(v, src[(size_t)(i - 1) * cols + j]);
                if (i < rows - 1) v = std::max(v, src[(size_t)(i + 1) * cols + j]);
                if (j > 0) v = std::max(v, src[(size_t)i * cols + j - 1]);
                if (j < cols - 1) v = std::max(v, src[(size_t)i * cols + j + 1]);
                dst[(size_t)i * cols + j] = v;
            }
        }
        return dst;
    }
    for (int i = 0; i < rows; i++) {
        for (int j = 0; j < cols; j++) {
            uint8_t v = 0;
            for (int l = std::max(0, j - r); l <= std::min(cols - 1, j + r); l++) {
                v = std::max(v, src[(size_t)i * cols + l]);
            }
            tmp[(size_t)i * cols + j] = v;
        }
    }
    for (int i = 0; i < rows; i++) {
        for (int j = 0; j < cols; j++) {
            uint8_t v = 0;
            for (int k = std::max(0, i - r); k <= std::min(rows - 1, i + r); k++) {
                v = std::max(v, tmp[(size_t)k * cols + j]);
            }
            dst[(size_t)i * cols + j] = v;
        }
    }
    return dst;
}

void clear_frame(std::vector<uint8_t>& m, int rows, int cols) {
    for (int j = 0; j < cols; j++) {
        m[j] = 0;
        m[(size_t)(rows - 1) * cols + j] = 0;
    }
    for (int i = 0; i < rows; i++) {
        m[(size_t)i * cols] = 0;
        m[(size_t)i * cols + cols - 1] = 0;
    }
}

template <typename T>
int inpaint(const uint8_t* hole, int height, int width, int channels, T* image,
            double radius) {
    int range = (int)std::lrint(radius);
    range = std::max(range, 1);
    range = std::min(range, 100);

    const int rows = height + 2, cols = width + 2;
    const size_t n = (size_t)rows * cols;

    std::vector<uint8_t> mask(n, KNOWN);
    for (int i = 0; i < height; i++) {
        for (int j = 0; j < width; j++) {
            if (hole[(size_t)i * width + j] != 0) {
                mask[(size_t)(i + 1) * cols + j + 1] = INSIDE;
            }
        }
    }
    std::vector<float> t(n, 1.0e6f);

    // The band: one cross step outside the hole, off the frame.
    std::vector<uint8_t> band = dilate(mask, rows, cols, 1, true);
    bool any = false;
    for (size_t k = 0; k < n; k++) {
        any = any || band[k] != 0;
        band[k] = (uint8_t)std::max(0, band[k] - mask[k]);
    }
    if (!any) {
        return 0;
    }
    clear_frame(band, rows, cols);

    MarchQueue inside;
    for (int i = 0; i < rows; i++) {
        for (int j = 0; j < cols; j++) {
            if (band[(size_t)i * cols + j] != 0) {
                inside.push(i, j, 0.0f);
                t[(size_t)i * cols + j] = 0.0f;
            }
        }
    }

    // The ring of width `range` around the hole, marched outwards.
    std::vector<uint8_t> ring = dilate(mask, rows, cols, range, false);
    for (size_t k = 0; k < n; k++) {
        ring[k] = (uint8_t)std::max(0, ring[k] - mask[k]);
    }
    MarchQueue outside;
    for (int i = 0; i < rows; i++) {
        for (int j = 0; j < cols; j++) {
            if (band[(size_t)i * cols + j] != 0) {
                outside.push(i, j, 0.0f);
            }
        }
    }
    for (size_t k = 0; k < n; k++) {
        ring[k] = (uint8_t)std::max(0, ring[k] - band[k]);
    }
    clear_frame(ring, rows, cols);
    march_outside(ring, t, rows, cols, outside);

    march_inside<T>(mask, t, rows, cols, image, channels, range, inside);
    return 0;
}

}  // namespace

extern "C" {

// Inpaint `image` (height, width, channels), in place, where `hole` is
// non-zero. `depth` is 8 (uint8, 1 or 3 channels) or 16 (uint16, 1
// channel). Returns 0, or -1 for an unsupported layout.
int hive_telea_inpaint(const uint8_t* hole, int height, int width, int channels, int depth,
                       void* image, double radius) {
    if (height <= 0 || width <= 0) {
        return -1;
    }
    if (depth == 8 && (channels == 1 || channels == 3)) {
        return inpaint<uint8_t>(hole, height, width, channels, (uint8_t*)image, radius);
    }
    if (depth == 16 && channels == 1) {
        return inpaint<uint16_t>(hole, height, width, channels, (uint16_t*)image, radius);
    }
    return -1;
}

}  // extern "C"
