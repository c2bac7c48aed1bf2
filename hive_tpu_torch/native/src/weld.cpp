// Vertex weld: sorted-unique with first-occurrence indices and inverse map.
//
// Replaces the numpy `np.unique(keys, return_index=True,
// return_inverse=True)` call in isosurface extraction
// (hive_tpu/ops/marching.py) — the per-extraction host weld over millions of
// 64-bit grid-edge keys. An LSD radix sort (8-bit digits, passes skipped
// when a digit is constant — keys are < dims^2 so the high bytes usually
// are) runs several times faster than numpy's argsort-based unique on this
// single-core host.
//
// Semantics match np.unique exactly: unique values ascending;
// first_index[r] = the SMALLEST original index holding the r-th unique
// value (LSD radix is stable, so the first element of each equal run keeps
// the lowest original index); inverse[i] = rank of keys[i].

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

// Shared radix-sort unique (see hive_weld_unique below for semantics).
// Returns the number of unique keys (<= n), or -1 on allocation failure.
static int64_t weld_sorted_unique(const uint64_t* keys, int64_t n,
                                  int64_t* first_index, int64_t* inverse) {
    if (n <= 0) {
        return 0;
    }

    // std::bad_alloc must not cross the extern "C" boundary (it would
    // abort the process); report -1 so the Python wrapper can fall back
    // to np.unique.
    std::vector<int64_t> order;
    std::vector<int64_t> scratch;
    try {
        order.resize(n);
        scratch.resize(n);
    } catch (...) {
        return -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        order[i] = i;
    }

    int64_t counts[256];

    for (int pass = 0; pass < 8; ++pass) {
        const int shift = pass * 8;

        std::memset(counts, 0, sizeof(counts));
        for (int64_t i = 0; i < n; ++i) {
            ++counts[(keys[order[i]] >> shift) & 0xFF];
        }

        // All keys share this digit: nothing to reorder.
        bool constant = false;
        for (int d = 0; d < 256; ++d) {
            if (counts[d] == n) {
                constant = true;
                break;
            }
        }
        if (constant) {
            continue;
        }

        int64_t offsets[256];
        int64_t total = 0;
        for (int d = 0; d < 256; ++d) {
            offsets[d] = total;
            total += counts[d];
        }

        for (int64_t i = 0; i < n; ++i) {
            const int64_t src = order[i];
            scratch[offsets[(keys[src] >> shift) & 0xFF]++] = src;
        }
        order.swap(scratch);
    }

    int64_t unique_count = 0;
    uint64_t prev = ~keys[order[0]];  // differs from the first key

    for (int64_t i = 0; i < n; ++i) {
        const int64_t src = order[i];
        const uint64_t key = keys[src];
        if (key != prev) {
            first_index[unique_count] = src;
            prev = key;
            ++unique_count;
        }
        inverse[src] = unique_count - 1;
    }

    return unique_count;
}

// Decode a packed oct-encoded normal (two unsigned fields at the given
// scale), fold the lower hemisphere back out, and accumulate into acc.
// Shared by hive_oct_average (16-bit fields) and hive_extract_assemble
// (8-bit fields riding fracnrm's high bits) — ONE definition of the fold
// math so the two paths cannot diverge.
static inline void accumulate_oct(float ux, float uy, float* acc) {
    const float ax = ux < 0.0f ? -ux : ux;
    const float ay = uy < 0.0f ? -uy : uy;
    const float nz = 1.0f - ax - ay;

    float nx = ux;
    float ny = uy;
    if (nz < 0.0f) {  // fold the lower hemisphere back out
        nx = (1.0f - ay) * (ux >= 0.0f ? 1.0f : -1.0f);
        ny = (1.0f - ax) * (uy >= 0.0f ? 1.0f : -1.0f);
    }

    acc[0] += nx;
    acc[1] += ny;
    acc[2] += nz;
}

static inline void normalise_rows(float* out, int64_t num_rows) {
    for (int64_t r = 0; r < num_rows; ++r) {
        float* acc = out + 3 * r;
        const float len2 = acc[0] * acc[0] + acc[1] * acc[1] + acc[2] * acc[2];
        if (len2 > 1e-24f) {
            const float inv = 1.0f / std::sqrt(len2);
            acc[0] *= inv;
            acc[1] *= inv;
            acc[2] *= inv;
        }
    }
}

extern "C" {

// Returns the number of unique keys (<= n), or -1 on allocation failure.
// first_index and inverse must hold n elements each.
int64_t hive_weld_unique(const uint64_t* keys, int64_t n,
                         int64_t* first_index, int64_t* inverse) {
    return weld_sorted_unique(keys, n, first_index, inverse);
}

// Per-welded-vertex average of oct-encoded (snorm16x2) normals, one pass.
//
// Replaces the numpy pipeline in hive_tpu/ops/marching.py
// (_decode_oct_average): decode u16x2 -> octahedral fold -> three
// bincount accumulations -> normalize. numpy makes ~10 full passes over
// the emitted-vertex arrays (millions of elements); this fuses decode +
// accumulate into one pass and normalizes over the (much smaller) unique
// set. No allocations, so no failure mode.
//
// packed:  n oct-encoded normals (low 16 bits = x, high = y, each
//          snorm-mapped to [0, 65535]).
// inverse: n welded ranks in [0, num_unique) (from hive_weld_unique).
// out:     num_unique * 3 floats (caller-allocated, overwritten).
void hive_oct_average(const uint32_t* packed, const int64_t* inverse,
                      int64_t n, int64_t num_unique, float* out) {
    std::memset(out, 0, sizeof(float) * 3 * num_unique);

    constexpr float kScale = 2.0f / 65535.0f;

    for (int64_t i = 0; i < n; ++i) {
        const uint32_t p = packed[i];
        const float ux = static_cast<float>(p & 0xFFFF) * kScale - 1.0f;
        const float uy = static_cast<float>(p >> 16) * kScale - 1.0f;
        accumulate_oct(ux, uy, out + 3 * inverse[i]);
    }

    normalise_rows(out, num_unique);
}

// Weld directly from the isosurface extraction lanes
// (hive_tpu/ops/marching.py 3-lane layout): the 64-bit weld key is
// (lo corner id << 6) | edge direction code, built inline instead of by a
// full numpy pass over the (multi-hundred-MB at scale) emitted arrays.
// Returns unique count or -1 on allocation failure.
int64_t hive_weld_unique_lanes(const int32_t* klo, const uint32_t* colcode,
                               int64_t n, int64_t* first_index,
                               int64_t* inverse) {
    if (n <= 0) {
        return 0;
    }

    std::vector<uint64_t> keys;
    try {
        keys.resize(n);
    } catch (...) {
        return -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        keys[i] = (static_cast<uint64_t>(static_cast<uint32_t>(klo[i])) << 6)
                  | (colcode[i] >> 24);
    }

    return weld_sorted_unique(keys.data(), n, first_index, inverse);
}

// Assemble the final mesh from the extraction lanes and the weld result —
// fuses what used to be ~10 numpy passes over the emitted arrays
// (position decode+lerp, colour unpack, oct-normal expand/decode/bincount,
// degenerate-face filter) into three tight loops: one over the unique
// vertices, one over the emitted vertices (normals), one over triangles.
//
// klo/colcode/fracnrm: the (n,) extraction lanes (marching.py _emit_core).
// first_index/inverse: from hive_weld_unique_lanes. `inverse` doubles as
// the triangle index buffer: non-degenerate triangles are compacted
// IN PLACE into its first 3*result entries (order preserved).
// dims_y/dims_z: volume Y/Z extents (corner id decode).
// out_verts (num_unique*3 f32, world coords), out_colors (num_unique*3 u8),
// out_normals (num_unique*3 f32, unit) are caller-allocated.
// Returns the kept triangle count. No allocations.
int64_t hive_extract_assemble(const int32_t* klo, const uint32_t* colcode,
                              const uint32_t* fracnrm,
                              const int64_t* first_index, int64_t* inverse,
                              int64_t n, int64_t num_unique,
                              int64_t dims_y, int64_t dims_z,
                              double voxel_size, const double* origin,
                              float* out_verts, uint8_t* out_colors,
                              float* out_normals) {
    const int64_t yz = dims_y * dims_z;

    for (int64_t r = 0; r < num_unique; ++r) {
        const int64_t i = first_index[r];
        const uint32_t cc = colcode[i];
        const uint32_t code = cc >> 24;
        const int64_t k = static_cast<uint32_t>(klo[i]);
        const float frac = static_cast<float>(fracnrm[i] & 0xFFFF)
                           * (1.0f / 65535.0f);

        const int64_t lo[3] = {k / yz, (k / dims_z) % dims_y, k % dims_z};
        for (int a = 0; a < 3; ++a) {
            const float delta =
                static_cast<float>(static_cast<int>((code >> (2 * a)) & 3) - 1);
            // f32 lerp (matches the numpy fallback), f64 world transform.
            const float p = static_cast<float>(lo[a]) + frac * delta;
            out_verts[3 * r + a] = static_cast<float>(
                static_cast<double>(p) * voxel_size + origin[a]);
        }

        out_colors[3 * r + 0] = cc & 0xFF;
        out_colors[3 * r + 1] = (cc >> 8) & 0xFF;
        out_colors[3 * r + 2] = (cc >> 16) & 0xFF;
    }

    // Per-welded-vertex average of the 8+8 oct normals riding the high 16
    // bits of fracnrm (same math as hive_oct_average at 8-bit scale).
    std::memset(out_normals, 0, sizeof(float) * 3 * num_unique);
    constexpr float kScale8 = 2.0f / 255.0f;
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t p = fracnrm[i] >> 16;
        const float ux = static_cast<float>(p & 0xFF) * kScale8 - 1.0f;
        const float uy = static_cast<float>((p >> 8) & 0xFF) * kScale8 - 1.0f;
        accumulate_oct(ux, uy, out_normals + 3 * inverse[i]);
    }
    normalise_rows(out_normals, num_unique);

    // Drop degenerate triangles (duplicate welded vertices), compacting the
    // survivors to the front of `inverse` viewed as (n/3, 3) faces.
    const int64_t num_tris = n / 3;
    int64_t kept = 0;
    for (int64_t t = 0; t < num_tris; ++t) {
        const int64_t a = inverse[3 * t];
        const int64_t b = inverse[3 * t + 1];
        const int64_t c = inverse[3 * t + 2];
        if (a != b && b != c && a != c) {
            inverse[3 * kept] = a;
            inverse[3 * kept + 1] = b;
            inverse[3 * kept + 2] = c;
            ++kept;
        }
    }
    return kept;
}

}  // extern "C"
