// Refine-pass pyramid query: the 5x5-cell depth-bounds reduction of the
// sparse TSDF integrator's band refinement, for sm_90a.
//
// Replaces hive_tpu/ops/pallas_refine.py:_build_kernel (the Pallas window
// reduce behind query_flat_pyramid_pallas). Contract: bit-identical to the
// plain query_flat_pyramid(grid=5, level_bias=-2) of
// hive_tpu_torch/ops/tsdf_sparse.py.
//
// Inputs per block b (int32, six rows of n): the covering level's flat
// offset and width, and the clamped cell ranges [cu0, cu1] x [cv0, cv1]
// computed by the shared torch function pyramid_cell_bounds (the level pick
// stays out of this file). The block reads cells (min(cv0+i, cv1),
// min(cu0+j, cu1)) for i, j in 0..4 of the flat pyramid of 32-bit words:
// bits 0-15 u16-mm depth min, bits 16-30 2-mm depth max, bit 31 all-valid.
// It reduces the integer fields (min, max, AND) and decodes once:
// dmin = min * 1e-3f; dmax = -inf at 0, +inf at >= 32767, else max * 2e-3f.
// The decode is monotone, so decoding after the reduction equals the plain
// version's reduction of decoded floats.
//
// Bound: 25 4-byte reads + 24 bytes of bounds in and 9 bytes out per block,
// about 133 B; at the main path's 4096 blocks that is ~0.5 MB, far below a
// microsecond of device memory time, so launch overhead bounds it. One
// thread per block keeps it simple; neighbouring threads read neighbouring
// bound entries, and the pyramid (2.8 MB at VGA) stays in L2.
//
// Compiled with -fmad=false; the decode multiplies are single IEEE roundings.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void refine_query_kernel(const int32_t* __restrict__ pyramid,
                                    int64_t pyramid_size,
                                    const int32_t* __restrict__ cells,  // (6, n)
                                    int64_t n,
                                    float* __restrict__ dmin,
                                    float* __restrict__ dmax,
                                    uint8_t* __restrict__ valid) {
    const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (b >= n) return;

    const int32_t off = cells[b];
    const int32_t w_l = cells[n + b];
    const int32_t cu0 = cells[2 * n + b];
    const int32_t cu1 = cells[3 * n + b];
    const int32_t cv0 = cells[4 * n + b];
    const int32_t cv1 = cells[5 * n + b];

    uint32_t mn = 0xFFFFu, mx = 0u, all = 1u;
    #pragma unroll
    for (int i = 0; i < 5; ++i) {
        const int32_t cv = min(cv0 + i, cv1);
        #pragma unroll
        for (int j = 0; j < 5; ++j) {
            const int32_t cu = min(cu0 + j, cu1);
            int64_t idx = static_cast<int64_t>(off) + static_cast<int64_t>(cv) * w_l + cu;
            // Never binds for bounds from pyramid_cell_bounds; keeps the
            // read in the buffer for any input.
            idx = idx < 0 ? 0 : (idx >= pyramid_size ? pyramid_size - 1 : idx);
            const uint32_t g = static_cast<uint32_t>(__ldg(pyramid + idx));
            mn = min(mn, g & 0xFFFFu);
            mx = max(mx, (g >> 16) & 0x7FFFu);
            all &= g >> 31;
        }
    }

    dmin[b] = static_cast<float>(mn) * 1e-3f;
    dmax[b] = mx == 0u ? -CUDART_INF_F
            : (mx >= 32767u ? CUDART_INF_F : static_cast<float>(mx) * 2e-3f);
    valid[b] = static_cast<uint8_t>(all);
}

}  // namespace

extern "C" int refine_query_launch(const void* pyramid, int64_t pyramid_size,
                                   const void* cells, int64_t n, void* dmin,
                                   void* dmax, void* valid, void* stream) {
    constexpr int kThreads = 256;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    refine_query_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(pyramid), pyramid_size,
        static_cast<const int32_t*>(cells), n, static_cast<float*>(dmin),
        static_cast<float*>(dmax), static_cast<uint8_t*>(valid));
    return static_cast<int>(cudaGetLastError());
}
