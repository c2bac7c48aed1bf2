// Patch gather: per block, samples of a frame window read straight from the
// frame, for sm_90a.
//
// Replaces scripts/micro_pallas_gather.py:make_pallas_fn (the 16 x 256
// window sampler prototype). Contract, for block b with window origin
// (v0[b], u0[b]) and window size ph x pw:
//   out[b][i] = frame[wv + (vv[b][i] - v0[b])][wu + (uu[b][i] - u0[b])]
// when 0 <= vv - v0 < ph and 0 <= uu - u0 < pw, else 0; (wv, wu) is the
// window origin clamped into the frame, where lax.dynamic_slice puts a
// window that would leave it (for an origin inside the frame, frame[vv][uu]).
//
// The TPU kernel kept the whole frame in VMEM and sampled each (8, 128)
// tile with a lane gather and a sublane gather, because Mosaic gathers only
// inside one vreg. Hopper gathers from any address and a VGA frame (1.2 MB)
// stays in the 50 MB L2, so there is no staging: each thread takes four
// consecutive samples of one block (one int4 load each of vv and uu, its
// block's origin once), reads each in-window word with __ldg at
// (wv + pv, wu + pu) and stores the four as one int4. The wrapper admits
// only blocks of a multiple of four samples in 16-byte aligned tensors.
//
// Bound: each distinct sampled frame word once, the origins once per block,
// and 8 B of coordinates in and 4 B out per sample: ~12 B per sample.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;

__global__ void patch_gather_kernel(const int32_t* __restrict__ frame,
                                    int32_t height, int32_t width,
                                    const int32_t* __restrict__ v0,
                                    const int32_t* __restrict__ u0,
                                    const int32_t* __restrict__ vv,
                                    const int32_t* __restrict__ uu,
                                    int32_t ph, int32_t pw, int32_t per_block,
                                    int64_t total, int32_t* __restrict__ out) {
    const int64_t first = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
    if (first >= total) return;
    // per_block % kVec == 0, so the kVec samples belong to one block.
    const int64_t b = first / per_block;
    const int32_t v0b = __ldg(v0 + b);
    const int32_t u0b = __ldg(u0 + b);
    const int32_t wv = min(max(v0b, 0), height - ph);
    const int32_t wu = min(max(u0b, 0), width - pw);

    const int4 v4 = __ldg(reinterpret_cast<const int4*>(vv + first));
    const int4 u4 = __ldg(reinterpret_cast<const int4*>(uu + first));
    const int32_t v[kVec] = {v4.x, v4.y, v4.z, v4.w};
    const int32_t u[kVec] = {u4.x, u4.y, u4.z, u4.w};
    int32_t o[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
        const int32_t pv = v[k] - v0b;
        const int32_t pu = u[k] - u0b;
        const bool inside = pv >= 0 && pv < ph && pu >= 0 && pu < pw;
        o[k] = inside ? __ldg(frame + static_cast<int64_t>(wv + pv) * width + (wu + pu)) : 0;
    }
    *reinterpret_cast<int4*>(out + first) = make_int4(o[0], o[1], o[2], o[3]);
}

}  // namespace

extern "C" int patch_gather_launch(const void* frame, int32_t height,
                                   int32_t width, const void* v0,
                                   const void* u0, const void* vv,
                                   const void* uu, int32_t blocks, int32_t ph,
                                   int32_t pw, int32_t per_block, void* out,
                                   void* stream) {
    constexpr int kThreads = 256;
    const int64_t total = static_cast<int64_t>(blocks) * per_block;
    const int64_t grid = (total / kVec + kThreads - 1) / kThreads;
    patch_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(frame), height, width,
        static_cast<const int32_t*>(v0), static_cast<const int32_t*>(u0),
        static_cast<const int32_t*>(vv), static_cast<const int32_t*>(uu),
        ph, pw, per_block, total, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
