// Band sampler: the per-voxel frame-word gather of the sparse TSDF
// integrator's band update, for sm_90a.
//
// Replaces hive_tpu/ops/pallas_sampler.py:build_patch_sampler (the Pallas
// block-window sampler). Contract: out[i] = frame[v[i], u[i]] for the
// clamped pixel coordinates of band_update_values; the coordinates are
// clamped once more here into [0, height) x [0, width) so a read never
// leaves the frame (a no-op for the integrator's inputs), exactly as the
// plain version does.
//
// The TPU kernel copied a tile-aligned 64x256 window per block into VMEM
// because Mosaic cannot gather arbitrarily; Hopper gathers from any
// address, so there is no window, no fit test and no routing: one thread
// per voxel reads its 32-bit word through the read-only path. A VGA frame
// is 1.2 MB and stays in the 50 MB L2.
//
// Bound: 8 B of coordinates in and 4 B out per voxel (the frame itself is
// read once, 1.2 MB), i.e. ~12 B per voxel: one 128-block trip (65,536
// voxels) moves ~0.8 MB + the frame, ~0.6 us of device memory time, so a
// launch's own cost bounds it at the main path's trip width.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void band_sample_kernel(const int32_t* __restrict__ frame,
                                   int32_t height, int32_t width,
                                   const int32_t* __restrict__ v,
                                   const int32_t* __restrict__ u,
                                   int64_t n, int32_t* __restrict__ out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int32_t vc = min(max(v[i], 0), height - 1);
    const int32_t uc = min(max(u[i], 0), width - 1);
    out[i] = __ldg(frame + static_cast<int64_t>(vc) * width + uc);
}

}  // namespace

extern "C" int band_sample_launch(const void* frame, int32_t height,
                                  int32_t width, const void* v, const void* u,
                                  int64_t n, void* out, void* stream) {
    constexpr int kThreads = 256;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    band_sample_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(frame), height, width,
        static_cast<const int32_t*>(v), static_cast<const int32_t*>(u), n,
        static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
