// Tile gather: take_along_axis of one small 32-bit tile, for sm_90a.
//
// Replaces scripts/micro_pallas_gather.py:q1 (q1_lane_kernel and
// q1_sublane_kernel), the probes of Mosaic's in-register gathers on an
// (8, 128) vreg tile. Contract, for a (rows, cols) tile:
//   axis 1 (lane):    out[r][c] = src[r][idx[r][c]]
//   axis 0 (sublane): out[r][c] = src[idx[r][c]][c]
// Indices must lie in [0, cols) or [0, rows); the kernel clamps them into
// the tile so a bad index never reads outside it (the plain version,
// torch.gather, raises on one instead).
//
// On the TPU both were single vector instructions on one vreg. Hopper has
// no register that holds the tile: a warp's __shfl_sync reaches 32 lanes
// and a 128-wide row spans four warps, so one block of rows * cols threads
// (1024 for the probe's tile) copies the tile into shared memory, syncs,
// and each thread writes one output word.
//
// Bound: 12 B per element (tile, index, output), 12 KB for the probe's
// tile, a few ns of device memory time: one launch of one block, i.e. the
// launch itself, bounds it at every size this kernel takes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void tile_gather_kernel(const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   int32_t rows, int32_t cols, int32_t axis,
                                   int32_t* __restrict__ out) {
    extern __shared__ int32_t tile[];
    const int32_t i = threadIdx.x;
    tile[i] = src[i];
    __syncthreads();
    const int32_t r = i / cols;
    const int32_t c = i - r * cols;
    const int32_t n = axis == 1 ? cols : rows;
    const int32_t j = min(max(idx[i], 0), n - 1);
    out[i] = axis == 1 ? tile[r * cols + j] : tile[j * cols + c];
}

}  // namespace

extern "C" int tile_gather_launch(const void* src, const void* idx,
                                  int32_t rows, int32_t cols, int32_t axis,
                                  void* out, void* stream) {
    const int32_t n = rows * cols;  // <= 1024, checked by the wrapper
    tile_gather_kernel<<<1, n, n * sizeof(int32_t),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(idx),
        rows, cols, axis, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
