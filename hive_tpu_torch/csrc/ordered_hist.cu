// Ordered histogram: per-row float32 sums of values by bin, each bin's
// entries added in entry order, for sm_90a.
//
// Replaces no TPU kernel. SIFT's orientation and descriptor histograms
// (hive_tpu_torch/ops/sift.py) must add their window samples in OpenCV's
// order to give OpenCV's (and the CPU's) float32 sums; scatter_add_ on CUDA
// adds with atomics in no fixed order, which moved the card's keypoints and
// descriptors from run to run. Contract, for a (rows, E) int32 index and
// float32 value:
//   out[r][b] = ((+0 + v[r][e0]) + v[r][e1]) + ...   over the e with
//               index[r][e] == b, in increasing e, each add __fadd_rn;
// entries whose index lies outside [0, bins) are skipped.
//
// Design: one warp owns one row, so that SIFT's calls (1378 rows at 360
// bins, 7497 at 36) spread over every SM (the first design gave a row to a
// thread: 44 warps at 360 bins); a block holds kWarps rows, each warp with
// its own histogram and its own ring of staged entries in shared memory.
// - Order. The warp takes 32 consecutive entries a step, lane l entry
//   e0 + l, so lane order is entry order. The lanes that hit one bin
//   (__match_any_sync) form a group. Its lowest lane, the leader, reads the
//   bin, adds its own value, then its peers' values in lane order (read
//   from the ring), one __fadd_rn each, and writes the bin back. Groups
//   hold different bins, so leaders never race, and a __syncwarp() orders
//   a step's writes before the next step's reads. So each bin takes its
//   entries in entry order, one rounded add each, from its running value:
//   the contract's sum. (Adding peers into a partial sum first would round
//   differently.) A stage's steps find their groups, and their leaders
//   read their first kAhead peer values, before any step adds: that work
//   waits on no sum, so the steps' loads and matches overlap, and only the
//   adds stay in series.
// - Skips. An entry whose index lies outside [0, bins), or whose value is
//   +0 or -0, is not added, and a step with nothing to add is skipped.
//   Skipping a zero is exact: the running sum starts at +0 and never
//   becomes -0 (in round to nearest, x + y is -0 only when both are -0, and
//   a nonzero exact sum of two floats is at least the smallest subnormal,
//   so it does not round to 0; the library is built without -ftz, so
//   subnormals stay), and s + (+-0) == s for every s that is not -0. A NaN
//   value makes its bin NaN, the card's canonical NaN. SIFT sends every
//   invalid window sample to bin 0 with value 0: about half of a
//   descriptor row, and half its steps.
// - Staging. Each warp keeps the next stage of kStage entries of its row
//   in flight while it sums the current one, copied into its ring with
//   4-byte cp.async (a row starts at any 4-byte offset: at 36 bins
//   E = 1089); each copy instruction moves 128 contiguous bytes for the
//   warp. A lane waits for its own copies (cp.async.wait_group), and a
//   __syncwarp() then shows every lane's to the warp.
//
// Bound: device memory, 8 B an entry read (index, value) and 4 B a bin
// written, over 3.35 TB/s. What this design runs at instead is instruction
// throughput: per 32 entries, the copies, the ring reads, a vote and a
// match, and for a step with entries to add, the leaders' reads and adds
// (the largest group's size) and a __syncwarp(); an H100 at 700 W read
// 0.096 ms at 360 bins (1.8x the bound) and 0.047 ms at 36 (2.4x).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // rows a block, one warp each
constexpr int kSteps = 8;              // 32-entry steps a stage
constexpr int kStage = 32 * kSteps;    // entries a stage
constexpr int kDepth = 2;              // stages in a warp's ring
constexpr int kAhead = 2;              // peer values a leader reads before its adds
constexpr int kRingWords = 2 * kDepth * kStage;   // index and value words a warp
constexpr unsigned kAll = 0xffffffffu;

// One 4-byte asynchronous copy into shared memory (at a shared-space address).
__device__ __forceinline__ void copy_async4(unsigned to, const void* from) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(from) : "memory");
}

__device__ __forceinline__ void commit_stage() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Returns once this thread's oldest stage in flight has landed, leaving the
// kDepth - 1 younger ones in flight.
__device__ __forceinline__ void wait_oldest_stage() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
}

__global__ void __launch_bounds__(kWarps * 32)
ordered_hist_kernel(const int32_t* __restrict__ index, const float* __restrict__ value,
                    int64_t rows, int64_t entries, int32_t bins, float* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = static_cast<int>(threadIdx.x) >> 5;
    const int lane = static_cast<int>(threadIdx.x) & 31;
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
    if (row >= rows) return;  // the whole warp; the block has no barrier

    int32_t* ring_idx = reinterpret_cast<int32_t*>(smem) + warp * kRingWords;
    float* ring_val = reinterpret_cast<float*>(ring_idx + kDepth * kStage);
    float* hist = reinterpret_cast<float*>(smem) + kWarps * kRingWords + warp * bins;
    const int32_t* row_idx = index + row * entries;
    const float* row_val = value + row * entries;
    const int64_t stages = (entries + kStage - 1) / kStage;

    // The lane's first index word of the ring, as a shared-space address,
    // and the distance from the index words to the value words.
    const unsigned ring_to = static_cast<unsigned>(__cvta_generic_to_shared(ring_idx)) + 4u * lane;
    constexpr unsigned kValues = 4u * kDepth * kStage;
    // Copies stage s (if the row has it) into its slot and closes a group,
    // empty past the row's end, so that every thread counts the same groups.
    auto fetch = [&](int64_t s, int slot) {
        if (s < stages) {
            const int64_t left = entries - s * kStage;
            const int32_t* from_idx = row_idx + s * kStage + lane;
            const float* from_val = row_val + s * kStage + lane;
            const unsigned to = ring_to + 4u * kStage * slot;
#pragma unroll
            for (int j = 0; j < kSteps; ++j) {
                if (left >= kStage || j * 32 + lane < left) {
                    copy_async4(to + 128u * j, from_idx + 32 * j);
                    copy_async4(to + kValues + 128u * j, from_val + 32 * j);
                }
            }
        }
        commit_stage();
    };

    for (int b = lane; b < bins; b += 32) hist[b] = 0.0f;
    for (int s = 0; s < kDepth - 1; ++s) fetch(s, s);
    __syncwarp();

    const unsigned below = (1u << lane) - 1u;  // the lanes before this one
    int read_slot = 0, write_slot = kDepth - 1;
    for (int64_t s = 0; s < stages; ++s) {
        fetch(s + kDepth - 1, write_slot);
        wait_oldest_stage();
        __syncwarp();  // every lane's copies of the stage, seen by every lane
        const int64_t left = entries - s * kStage;
        const int n = left < kStage ? static_cast<int>(left) : kStage;
        const int32_t* staged_idx = ring_idx + read_slot * kStage;
        const float* staged_val = ring_val + read_slot * kStage;
        // First, for every step, without a branch: the entries (an entry
        // that is not added gets bin -1), the groups (a lane that is not
        // its group's leader then gets bin -1 too), and the first kAhead
        // peer values of each leader, read from the ring (+0 past the
        // group's end). None of it waits on the sums, so the steps' loads
        // and matches overlap.
        int32_t bin[kSteps];
        float v[kSteps], ahead[kSteps][kAhead];
        unsigned rest[kSteps];
        unsigned busy = 0u;  // bit j: step j has an entry to add
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
            const int at = j * 32 + lane;
            bin[j] = -1;
            v[j] = 0.0f;
            if (at < n) {
                bin[j] = staged_idx[at];
                v[j] = staged_val[at];
            }
            if (static_cast<uint32_t>(bin[j]) >= static_cast<uint32_t>(bins)
                || (__float_as_uint(v[j]) << 1) == 0u) {
                bin[j] = -1;
            }
        }
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
            busy |= (__ballot_sync(kAll, bin[j] >= 0) != 0u ? 1u : 0u) << j;
            const unsigned peers = __match_any_sync(kAll, bin[j]);
            if ((peers & below) != 0u) bin[j] = -1;  // only the leader adds
            rest[j] = peers & (peers - 1u);
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
                const float peer = staged_val[j * 32 + (rest[j] != 0u ? __ffs(rest[j]) - 1 : lane)];
                ahead[j][k] = rest[j] != 0u ? peer : 0.0f;
                rest[j] &= rest[j] - 1u;
            }
        }
        // Then the adds, step after step: each leader reads its bin, adds
        // its own value and its peers' in lane order, and writes it back.
        // Past the group's end a leader adds +0 (ahead's filler), which
        // leaves its sum as it is: the sum is not -0 (see Skips).
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
            if ((busy >> j & 1u) == 0u) continue;  // the same on every lane
            if (bin[j] >= 0) {
                float sum = __fadd_rn(hist[bin[j]], v[j]);
#pragma unroll
                for (int k = 0; k < kAhead; ++k) sum = __fadd_rn(sum, ahead[j][k]);
                // A group larger than kAhead + 1 reads the rest one by one.
                for (unsigned more = rest[j]; more != 0u; more &= more - 1u) {
                    sum = __fadd_rn(sum, staged_val[j * 32 + __ffs(more) - 1]);
                }
                hist[bin[j]] = sum;
            }
            __syncwarp();
        }
        // Every lane is done with the stage's slot before it is refilled.
        __syncwarp();
        read_slot = read_slot + 1 == kDepth ? 0 : read_slot + 1;
        write_slot = write_slot + 1 == kDepth ? 0 : write_slot + 1;
    }

    float* row_out = out + row * bins;
    for (int b = lane; b < bins; b += 32) row_out[b] = hist[b];
}

}  // namespace

extern "C" int ordered_hist_launch(const void* index, const void* value, int64_t rows,
                                   int64_t entries, int32_t bins, void* out, void* stream) {
    // 16 KB of rings and 4 KB a block per 256 bins: under the 48 KB a block
    // may use without asking up to the wrapper's 512 bins.
    const size_t smem = sizeof(float) * kWarps * (kRingWords + static_cast<size_t>(bins));
    const int64_t blocks = (rows + kWarps - 1) / kWarps;
    ordered_hist_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(index), static_cast<const float*>(value), rows, entries,
        bins, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
