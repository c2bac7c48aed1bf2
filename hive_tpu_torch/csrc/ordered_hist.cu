// Ordered histogram: per-row float32 sums of values by bin, each bin's
// entries added in entry order, for sm_90a.
//
// Replaces no TPU kernel. SIFT's orientation and descriptor histograms
// (hive_tpu_torch/ops/sift.py) must add their window samples in OpenCV's
// order to give OpenCV's (and the CPU's) float32 sums; scatter_add_ on CUDA
// adds with atomics in no fixed order, which moved the card's keypoints and
// descriptors from run to run. Contract, for a (rows, E) int32 index and
// float32 value:
//   out[r][b] = ((0 + v[r][e0]) + v[r][e1]) + ...   over the e with
//               index[r][e] == b, in increasing e, each add __fadd_rn;
// entries whose index lies outside [0, bins) are skipped.
//
// Design: one thread owns one row. A block is one warp of 32 rows; each
// row's histogram lives in shared memory (row stride bins | 1, odd, so the
// warp's rows start on different banks). The warp stages a tile of 32
// entries of each of its rows through shared memory, read as 32
// consecutive words a row (coalesced), then each thread walks its row's
// tile in order. The adds of one row are a serial chain by contract, so no
// tensor cores and no tree reduction can shorten it.
//
// Bound: 8 B an entry read (index, value) and 4 B a bin written, over
// 3.35 TB/s. The serial chain of shared-memory adds (a few cycles each, one
// chain a thread) is what this simple design runs at instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;           // rows a block, one thread each
constexpr int kTile = 32;           // entries of each row staged at a time
constexpr int kStride = kTile + 1;  // staged row stride, off the bank period

__global__ void ordered_hist_kernel(const int32_t* __restrict__ index,
                                    const float* __restrict__ value,
                                    int64_t rows, int64_t entries, int32_t bins,
                                    float* __restrict__ out) {
    extern __shared__ float smem[];
    const int32_t hstride = bins | 1;
    float* hist = smem;
    int32_t* s_idx = reinterpret_cast<int32_t*>(hist + kRows * hstride);
    float* s_val = reinterpret_cast<float*>(s_idx + kRows * kStride);

    const int lane = threadIdx.x;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
    const int nrows = static_cast<int>(rows - row0 < kRows ? rows - row0 : kRows);
    for (int i = lane; i < kRows * hstride; i += kRows) hist[i] = 0.0f;
    __syncwarp();

    float* mine = hist + lane * hstride;
    for (int64_t e0 = 0; e0 < entries; e0 += kTile) {
        const int n = static_cast<int>(entries - e0 < kTile ? entries - e0 : kTile);
        if (lane < n) {
            for (int r = 0; r < nrows; ++r) {
                const int64_t at = (row0 + r) * entries + e0 + lane;
                s_idx[r * kStride + lane] = index[at];
                s_val[r * kStride + lane] = value[at];
            }
        }
        __syncwarp();
        if (lane < nrows) {
            const int32_t* my_idx = s_idx + lane * kStride;
            const float* my_val = s_val + lane * kStride;
            for (int k = 0; k < n; ++k) {
                const int32_t b = my_idx[k];
                if (b >= 0 && b < bins) mine[b] = __fadd_rn(mine[b], my_val[k]);
            }
        }
        __syncwarp();
    }

    for (int r = 0; r < nrows; ++r) {
        for (int j = lane; j < bins; j += kRows) {
            out[(row0 + r) * bins + j] = hist[r * hstride + j];
        }
    }
}

}  // namespace

extern "C" int ordered_hist_launch(const void* index, const void* value, int64_t rows,
                                   int64_t entries, int32_t bins, void* out, void* stream) {
    const size_t smem = sizeof(float) * kRows * (bins | 1)
                        + (sizeof(int32_t) + sizeof(float)) * kRows * kStride;
    // Above 48 KB a block's dynamic shared memory must be asked for.
    cudaError_t err = cudaFuncSetAttribute(ordered_hist_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t blocks = (rows + kRows - 1) / kRows;
    ordered_hist_kernel<<<static_cast<unsigned>(blocks), kRows, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(index), static_cast<const float*>(value), rows, entries,
        bins, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
