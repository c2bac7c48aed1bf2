// Band update: projection, frame sampling, unpack and the TSDF / weight /
// colour running-mean update of every band voxel of one frame, in place, in
// one launch, for sm_90a.
//
// Replaces, on the integrator's main path,
// hive_tpu/ops/pallas_sampler.py:build_patch_sampler together with the trip
// of XLA code around it. Contract: ops/band_update.py:band_update_plain.
// For slab row ids[k] (row = id / sub, s = id % sub) and in-slab voxel i
// (z-major: i = iz*bx*by + ix*by + iy):
//   cam[a] = base[k][a] + ix*step[a][0] + iy*step[a][1] + iz*step[a][2]
//   (u, v) = rint(f * cam / safe_z + c);   in_view = z > 1e-6 and inside
//   word(s) at the clamped pixel -> depth, rgb
//   valid = in_view && depth > 0 && sdf >= -trunc; upd = valid && w_obs > 0
//   weight += w_obs; tsdf and the three colours take the running means.
// tsdf and weight rows are id * bvs; colour channel ch of the slab is row
// (row*3 + ch)*sub + s (units of bvs), which covers both the SUB = 1
// (nb, 3*BV) layout and the SUB > 1 slab view.
//
// Float math rounds like the plain PyTorch version on the same card: the
// library builds with -fmad=false, and the arithmetic is written with _rn
// intrinsics besides, so nothing is contracted except the __fmaf_rn calls,
// which stand exactly where the plain version calls torch.addcmul; the sums
// of the camera coordinates go left to right; u and v round half to even
// (rintf, as torch.round); the truncation scale multiplies by the f32
// reciprocal; every division is IEEE. A bf16 state loads exactly and
// stores with __float2bfloat16_rn, which rounds as .to(torch.bfloat16).
//
// Design: the TPU sampled one 128-block trip per launch from a tile-aligned
// window in VMEM and left projection and update to XLA around it. Here one
// launch covers the frame's whole band: one block per slab row, the row's
// voxels over the block's threads (two per thread at 512 voxels), each
// projected, sampled, unpacked and updated in registers. A thread keeps one
// (ix, iy) column and steps along z, so it divides no index per voxel and
// adds one term per coordinate. It loads its voxel's state before it
// samples the frame, so the two loads overlap; that reads the state of
// voxels the frame leaves as they are too, but reading it only for a valid
// voxel, after the frame word, was slower on an H100 (the two loads in
// series). The frame (1.2 MB at VGA) stays in the 50 MB L2 and is read
// with __ldg; a row's tsdf, weight and colour segments are contiguous, so
// state reads and writes are coalesced. A value that does not change is
// not written.
//
// Bound: device memory. Per valid voxel, its state read once (10 B for
// bf16, 20 B for f32); each changed value written once; per row, its id and
// base (20 B); each distinct frame word a voxel in view samples once. The
// float work (~90 operations per voxel) is under a third of that at the
// card's f32 rate.

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The plain version's constants, rounded from double to f32 as PyTorch
// rounds a Python float.
constexpr float kMinZ = static_cast<float>(1e-6);
constexpr float kMinW = static_cast<float>(1e-12);
constexpr float kMm = static_cast<float>(1e-3);
constexpr float k5 = static_cast<float>(255.0 / 31.0);
constexpr float k6 = static_cast<float>(255.0 / 63.0);

// Layout of scal (ops/band_update.py:band_scalars).
enum { kFx, kFy, kCx, kCy, kTrunc, kInvTrunc, kObsWeight, kStep, kScalars = kStep + 9 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stores x in the state's dtype where that changes the slot's bits (``old``
// is the slot's value as loaded): the plain version writes every value
// back, and an unchanged one leaves the same bits.
__device__ __forceinline__ void store_changed(float* p, float old, float x) {
    if (__float_as_uint(x) != __float_as_uint(old)) *p = x;
}
__device__ __forceinline__ void store_changed(__nv_bfloat16* p, __nv_bfloat16 old, float x) {
    const __nv_bfloat16 b = __float2bfloat16_rn(x);
    if (__bfloat16_as_ushort(b) != __bfloat16_as_ushort(old)) *p = b;
}

template <typename T, bool kRgb888>
__global__ void band_update_kernel(const int64_t* __restrict__ ids,
                                   const float* __restrict__ base,
                                   const float* __restrict__ scal,
                                   const int32_t* __restrict__ words,
                                   const int32_t* __restrict__ colour_words,
                                   int32_t height, int32_t width, T* __restrict__ tsdf,
                                   T* __restrict__ weight, T* __restrict__ color,
                                   int32_t bx, int32_t by, int32_t bvs, int32_t sub) {
    __shared__ float s[kScalars];
    // Strided: a slab of fewer than kScalars voxels runs fewer threads.
    for (int j = threadIdx.x; j < kScalars; j += blockDim.x) s[j] = scal[j];
    const int64_t k = blockIdx.x;
    const int64_t id = ids[k];
    const float b[3] = {base[k * 3], base[k * 3 + 1], base[k * 3 + 2]};
    __syncthreads();

    const int64_t row = id / sub;
    const int64_t slab = id - row * sub;
    T* t_row = tsdf + id * bvs;
    T* w_row = weight + id * bvs;
    T* c_row[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c_row[ch] = color + ((row * 3 + ch) * sub + slab) * bvs;

    const float trunc = s[kTrunc];
    const float inv_trunc = s[kInvTrunc];
    const float obs_weight = s[kObsWeight];

    // The block's thread count is a multiple of the bx * by voxels of one z
    // layer, so a thread keeps its (ix, iy) and steps along z: the first two
    // terms of each camera coordinate are the thread's own.
    const int32_t plane = bx * by;
    const int32_t ix = (static_cast<int32_t>(threadIdx.x) / by) % bx;
    const int32_t iy = static_cast<int32_t>(threadIdx.x) % by;
    float xy[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        xy[a] = __fadd_rn(__fadd_rn(b[a], __fmul_rn(static_cast<float>(ix), s[kStep + a * 3])),
                          __fmul_rn(static_cast<float>(iy), s[kStep + a * 3 + 1]));
    }
    const int32_t dz = blockDim.x / plane;

    for (int32_t i = threadIdx.x, iz = threadIdx.x / plane; i < bvs; i += blockDim.x, iz += dz) {
        // The state first: its loads do not wait on the frame's.
        const T w_raw = w_row[i];
        const T t_raw = t_row[i];
        T c_raw[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) c_raw[ch] = c_row[ch][i];

        float cam[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            cam[a] = __fadd_rn(xy[a], __fmul_rn(static_cast<float>(iz), s[kStep + a * 3 + 2]));
        }
        const float cz = cam[2];
        const float safe_z = cz > kMinZ ? cz : 1.0f;
        const int32_t u = static_cast<int32_t>(
            rintf(__fadd_rn(__fdiv_rn(__fmul_rn(s[kFx], cam[0]), safe_z), s[kCx])));
        const int32_t v = static_cast<int32_t>(
            rintf(__fadd_rn(__fdiv_rn(__fmul_rn(s[kFy], cam[1]), safe_z), s[kCy])));
        const bool in_view = cz > kMinZ && u >= 0 && u < width && v >= 0 && v < height;
        const int64_t pixel = static_cast<int64_t>(min(max(v, 0), height - 1)) * width
                              + min(max(u, 0), width - 1);

        float depth, rgb[3];
        if constexpr (kRgb888) {
            depth = __int_as_float(__ldg(words + pixel));
            const int32_t c = __ldg(colour_words + pixel);
            rgb[0] = static_cast<float>(c & 0xFF);
            rgb[1] = static_cast<float>((c >> 8) & 0xFF);
            rgb[2] = static_cast<float>((c >> 16) & 0xFF);
        } else {
            const int32_t w = __ldg(words + pixel);
            depth = __fmul_rn(static_cast<float>(w & 0xFFFF), kMm);
            rgb[0] = __fmul_rn(static_cast<float>((w >> 16) & 31), k5);
            rgb[1] = __fmul_rn(static_cast<float>((w >> 21) & 63), k6);
            rgb[2] = __fmul_rn(static_cast<float>((w >> 27) & 31), k5);
        }

        const float sdf = __fsub_rn(depth, cz);
        const bool valid = in_view && depth > 0.0f && sdf >= -trunc;
        float dist = __fmul_rn(sdf, inv_trunc);
        dist = dist > 1.0f ? 1.0f : dist;
        const float w_obs = valid ? obs_weight : 0.0f;
        const float w_old = to_f32(w_raw);
        const float w_new = __fadd_rn(w_old, w_obs);
        const float safe_w = w_new < kMinW ? kMinW : w_new;
        store_changed(w_row + i, w_raw, w_new);
        if (!(valid && w_obs > 0.0f)) continue;  // tsdf and colour stay

        const float t_old = to_f32(t_raw);
        store_changed(t_row + i, t_raw,
                      __fdiv_rn(__fmaf_rn(t_old, w_old, __fmul_rn(dist, w_obs)), safe_w));
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            store_changed(c_row[ch] + i, c_raw[ch],
                          __fdiv_rn(__fmaf_rn(to_f32(c_raw[ch]), w_old,
                                              __fmul_rn(rgb[ch], w_obs)), safe_w));
        }
    }
}

}  // namespace

extern "C" int band_update_launch(const void* ids, const void* base, const void* scal,
                                  int64_t rows, const void* words,
                                  const void* colour_words, int32_t height,
                                  int32_t width, void* tsdf, void* weight, void* color,
                                  int32_t bf16, int32_t rgb888, int32_t bx, int32_t by,
                                  int32_t bvs, int32_t sub, void* stream) {
    // A multiple of one z layer's bx * by voxels (checked <= 1024 by the
    // wrapper), about 256 threads, no more layers than a slab has.
    const int plane = bx * by;
    const int threads = plane * std::max(1, std::min(256 / plane, bvs / plane));
    const auto s = static_cast<cudaStream_t>(stream);
    const auto launch = [&](auto kernel, auto* state) {
        using T = std::remove_pointer_t<decltype(state)>;
        kernel<<<static_cast<unsigned>(rows), threads, 0, s>>>(
            static_cast<const int64_t*>(ids), static_cast<const float*>(base),
            static_cast<const float*>(scal), static_cast<const int32_t*>(words),
            static_cast<const int32_t*>(colour_words), height, width, static_cast<T*>(tsdf),
            static_cast<T*>(weight), static_cast<T*>(color), bx, by, bvs, sub);
    };
    if (bf16) {
        __nv_bfloat16* t = nullptr;
        if (rgb888) launch(band_update_kernel<__nv_bfloat16, true>, t);
        else launch(band_update_kernel<__nv_bfloat16, false>, t);
    } else {
        float* t = nullptr;
        if (rgb888) launch(band_update_kernel<float, true>, t);
        else launch(band_update_kernel<float, false>, t);
    }
    return static_cast<int>(cudaGetLastError());
}
