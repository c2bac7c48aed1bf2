// Fused band trip: projection, window sampling, u32 unpack and the
// TSDF / weight / colour running-mean update of one trip of state rows in
// one launch, for sm_90a.
//
// Replaces scripts/micro_pallas_fused_band.py:make_fused, both variants
// from one template: kProject = true projects each voxel from its row's
// block origin and the in-block offsets (project_in_kernel=True);
// kProject = false takes (v, u, cam_z) computed outside ("half-fused").
// Contract (ops/fused_band.py:fused_band_plain): gathered rows in, updated
// rows out, written in place (the TPU kernel aliased them the same way).
// Each voxel samples its row's ph x pw window at its clamped pixel clamped
// once more into the window, so a lane outside the window reads the
// window's edge word, as the TPU kernel does; a row whose valid flag is 0
// (a dummy row) keeps its tsdf and colour.
//
// Float math rounds like the plain PyTorch version on the same card: the
// library builds with -fmad=false, so nothing is contracted except the
// __fmaf_rn calls, which stand exactly where the plain version calls
// torch.addcmul (an FMA on the card and on the CPU, and XLA's contraction
// on the CPU); the truncation scale is a multiply by the f32 reciprocal,
// as XLA rewrites x / const; u and v round half to even (rintf, as
// torch.round and jnp.round); every division is IEEE (no fast math).
//
// Design: one block per trip row, one thread per voxel (512 for 8^3
// blocks). The TPU kernel DMA'd a 64 x 256 window per row into VMEM,
// double-buffered, and sampled it with in-vreg gathers. A 64 KB window
// exceeds the 48 KB of default shared memory, and each voxel reads one word
// of it, so here each thread reads its word straight from the frame (1.2 MB
// at VGA, resident in the 50 MB L2) at the window-clamped pixel: the same
// word, no staging.
//
// Bound: 40 B of row state per voxel (tsdf, weight, 3 colours, in and out)
// plus each distinct frame word once and a few bytes per row: device
// memory, ~0.8 us for one 128-row trip; the float work (~60 operations per
// voxel) is a tenth of that at the card's f32 rate.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// The plain version's constants, rounded from double to f32 as PyTorch
// rounds a Python float.
constexpr float kMinZ = static_cast<float>(1e-6);
constexpr float kMinW = static_cast<float>(1e-12);
constexpr float kMm = static_cast<float>(1e-3);
constexpr float k5 = static_cast<float>(255.0 / 31.0);
constexpr float k6 = static_cast<float>(255.0 / 63.0);

struct Camera {
    float fx, fy, cx, cy;
};

template <bool kProject>
__global__ void fused_band_kernel(const int32_t* __restrict__ frame,
                                  int32_t height, int32_t width,
                                  const int32_t* __restrict__ win_v0,
                                  const int32_t* __restrict__ win_u0,
                                  const int32_t* __restrict__ valid,
                                  const float* __restrict__ scal,
                                  const float* __restrict__ origins,
                                  const float* __restrict__ iota,
                                  const int32_t* __restrict__ coord_v,
                                  const int32_t* __restrict__ coord_u,
                                  const float* __restrict__ coord_z,
                                  float* __restrict__ tsdf,
                                  float* __restrict__ weight,
                                  float* __restrict__ color, int32_t voxels,
                                  int32_t ph, int32_t pw, Camera cam,
                                  float trunc, float inv_trunc) {
    const int32_t row = blockIdx.x;
    const float obs_weight = scal[0];
    const bool valid_row = valid[row] > 0;
    const int32_t v0 = win_v0[row];
    const int32_t u0 = win_u0[row];
    // Where the window lies in the frame (a slice that would leave the
    // frame is shifted back into it, as lax.dynamic_slice does).
    const int32_t wv = min(max(v0, 0), height - ph);
    const int32_t wu = min(max(u0, 0), width - pw);

    for (int32_t i = threadIdx.x; i < voxels; i += blockDim.x) {
        const int64_t at = static_cast<int64_t>(row) * voxels + i;
        float cz;
        int32_t u, v;
        if constexpr (kProject) {
            const float wx = origins[row * 3 + 0] + iota[i];
            const float wy = origins[row * 3 + 1] + iota[voxels + i];
            const float wz = origins[row * 3 + 2] + iota[2 * voxels + i];
            // R[k] . w + t[k]: two FMAs, then the translation.
            const float cam_x = __fmaf_rn(wz, scal[3], __fmaf_rn(wy, scal[2], scal[1] * wx)) + scal[10];
            const float cam_y = __fmaf_rn(wz, scal[6], __fmaf_rn(wy, scal[5], scal[4] * wx)) + scal[11];
            cz = __fmaf_rn(wz, scal[9], __fmaf_rn(wy, scal[8], scal[7] * wx)) + scal[12];
            const float safe_z = cz > kMinZ ? cz : 1.0f;
            u = static_cast<int32_t>(rintf(cam.fx * cam_x / safe_z + cam.cx));
            v = static_cast<int32_t>(rintf(cam.fy * cam_y / safe_z + cam.cy));
        } else {
            u = coord_u[at];
            v = coord_v[at];
            cz = coord_z[at];
        }
        const bool in_view = cz > kMinZ && u >= 0 && u < width && v >= 0 && v < height;
        const int32_t pv = min(max(min(max(v, 0), height - 1) - v0, 0), ph - 1);
        const int32_t pu = min(max(min(max(u, 0), width - 1) - u0, 0), pw - 1);
        const int32_t w = __ldg(frame + static_cast<int64_t>(wv + pv) * width + (wu + pu));

        const float depth = static_cast<float>(w & 0xFFFF) * kMm;
        const float rgb[3] = {static_cast<float>((w >> 16) & 31) * k5,
                              static_cast<float>((w >> 21) & 63) * k6,
                              static_cast<float>((w >> 27) & 31) * k5};

        const float sdf = depth - cz;
        const bool ok = in_view && depth > 0.0f && sdf >= -trunc && valid_row;
        float dist = sdf * inv_trunc;
        dist = dist > 1.0f ? 1.0f : dist;
        const float w_obs = ok ? obs_weight : 0.0f;
        const float w_old = weight[at];
        const float w_new = w_old + w_obs;
        const float safe_w = w_new < kMinW ? kMinW : w_new;

        const float t_old = tsdf[at];
        tsdf[at] = ok ? __fmaf_rn(t_old, w_old, dist * w_obs) / safe_w : t_old;
        weight[at] = w_new;
        float* c = color + static_cast<int64_t>(row) * 3 * voxels + i;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const float c_old = c[ch * voxels];
            c[ch * voxels] = ok ? __fmaf_rn(c_old, w_old, rgb[ch] * w_obs) / safe_w : c_old;
        }
    }
}

}  // namespace

extern "C" int fused_band_launch(int32_t project_in_kernel, const void* frame,
                                 int32_t height, int32_t width,
                                 const void* win_v0, const void* win_u0,
                                 const void* valid, const void* scal,
                                 const void* origins, const void* iota,
                                 const void* coord_v, const void* coord_u,
                                 const void* coord_z, void* tsdf, void* weight,
                                 void* color, int32_t rows, int32_t voxels,
                                 int32_t ph, int32_t pw, float fx, float fy,
                                 float cx, float cy, float trunc,
                                 float inv_trunc, void* stream) {
    const int threads = std::min(512, (voxels + 31) / 32 * 32);
    const Camera cam{fx, fy, cx, cy};
    const auto s = static_cast<cudaStream_t>(stream);
    const auto launch = [&](auto kernel) {
        kernel<<<rows, threads, 0, s>>>(
            static_cast<const int32_t*>(frame), height, width,
            static_cast<const int32_t*>(win_v0), static_cast<const int32_t*>(win_u0),
            static_cast<const int32_t*>(valid), static_cast<const float*>(scal),
            static_cast<const float*>(origins), static_cast<const float*>(iota),
            static_cast<const int32_t*>(coord_v), static_cast<const int32_t*>(coord_u),
            static_cast<const float*>(coord_z), static_cast<float*>(tsdf),
            static_cast<float*>(weight), static_cast<float*>(color), voxels, ph, pw,
            cam, trunc, inv_trunc);
    };
    if (project_in_kernel) {
        launch(fused_band_kernel<true>);
    } else {
        launch(fused_band_kernel<false>);
    }
    return static_cast<int>(cudaGetLastError());
}
