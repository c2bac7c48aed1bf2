// Patch gather: per block, samples of a frame window staged in shared
// memory, for sm_90a.
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
// inside one vreg. Here one block per window copies the window (16 KB at
// 16 x 256) into shared memory with coalesced row reads, syncs, and each of
// the block's threads gathers one sample from shared memory.
//
// Bound: what the function must move is each distinct sampled frame word
// once, 8 B of coordinates in and 4 B out per sample: ~12 B per sample.
// The window copy reads ph * pw words for 512 samples (8x the samples at
// 16 x 256), so the kernel moves ~8x more L2 traffic than a direct gather
// (the band sampler's design); it stays to measure that trade on this card.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void patch_gather_kernel(const int32_t* __restrict__ frame,
                                    int32_t height, int32_t width,
                                    const int32_t* __restrict__ v0,
                                    const int32_t* __restrict__ u0,
                                    const int32_t* __restrict__ vv,
                                    const int32_t* __restrict__ uu,
                                    int32_t ph, int32_t pw, int32_t per_block,
                                    int32_t* __restrict__ out) {
    extern __shared__ int32_t window[];
    const int32_t b = blockIdx.x;
    const int32_t v0b = v0[b];
    const int32_t u0b = u0[b];
    const int32_t wv = min(max(v0b, 0), height - ph);
    const int32_t wu = min(max(u0b, 0), width - pw);
    for (int32_t k = threadIdx.x; k < ph * pw; k += blockDim.x) {
        const int32_t r = k / pw;
        window[k] = __ldg(frame + static_cast<int64_t>(wv + r) * width + wu + (k - r * pw));
    }
    __syncthreads();
    for (int32_t i = threadIdx.x; i < per_block; i += blockDim.x) {
        const int64_t at = static_cast<int64_t>(b) * per_block + i;
        const int32_t pv = vv[at] - v0b;
        const int32_t pu = uu[at] - u0b;
        const bool inside = pv >= 0 && pv < ph && pu >= 0 && pu < pw;
        out[at] = inside ? window[pv * pw + pu] : 0;
    }
}

}  // namespace

extern "C" int patch_gather_launch(const void* frame, int32_t height,
                                   int32_t width, const void* v0,
                                   const void* u0, const void* vv,
                                   const void* uu, int32_t blocks, int32_t ph,
                                   int32_t pw, int32_t per_block, void* out,
                                   void* stream) {
    const int threads = std::min(1024, (per_block + 31) / 32 * 32);
    // <= 48 KB, the default dynamic shared memory, checked by the wrapper.
    const size_t smem = static_cast<size_t>(ph) * pw * sizeof(int32_t);
    patch_gather_kernel<<<blocks, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(frame), height, width,
        static_cast<const int32_t*>(v0), static_cast<const int32_t*>(u0),
        static_cast<const int32_t*>(vv), static_cast<const int32_t*>(uu),
        ph, pw, per_block, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
}
