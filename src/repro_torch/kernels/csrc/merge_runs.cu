// The merge unit: k ascending runs of 64-bit keys merged in one launch,
// each entry carrying its int32 source index; and row-wise merges of
// independent run pairs.
//
// Replaces the TPU kernel `_merge_kernel` / `_merge_pallas` /
// `bitonic_merge_pair` (kernels/merge_runs/merge_runs.py of the JAX
// package): the merge unit that turns the per-thread update logs into the
// commit-ordered final log, and merges dictionaries. The TPU version
// concatenates A with reversed B and runs log2(2w) compare-exchange stages
// over (hi, lo) int32 key lanes, padded to a power of two of at least 128,
// and merges k runs as a tournament of k - 1 such pairs.
//
// What bounds it on an H100: bytes, 8 per entry in and 12 out (the key and
// its source index); a ship batch is at most 1,024 entries (about 8e-6 ms
// of bytes), so in practice the launch itself and the host's work around
// it. The design therefore does a k-way merge in ONE launch with no
// padding and no stages: keys are compared as native int64, and every
// entry finds its output slot by itself. For the entry at index i of run r
//     slot = i + sum over s < r of upper_bound(run_s, key)
//              + sum over s > r of lower_bound(run_s, key),
// so ties go in run order, as a stable sort of the concatenation orders
// them, and no key value is special (int64.max merges like any other).
// Each entry is read once and written once. The k + 1 run offsets travel
// in the launch's parameters (no copy to the device). When all the keys
// fit in shared memory (up to 4,096: 32 KB; a ship batch's 1,024 take 8
// KB) every block stages them there and the k - 1 binary searches stay in
// shared memory; larger inputs search device memory (L1/L2).
//
// `merge_runs` keeps the row-wise pair merge (rows independent,
// blockIdx.y): A's entries count B's keys below them (lower bound), B's
// count A's keys at or below them (upper bound), so equal keys keep A
// first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RUNS = 64;          // runs a k-way launch takes
constexpr int SMEM_KEYS = 4096;       // keys staged in shared memory

struct RunOffsets {
    int at[MAX_RUNS + 1];             // run r is keys[at[r] .. at[r + 1])
};

__global__ void __launch_bounds__(THREADS)
merge_runs_kernel(const long long* __restrict__ a, const int* __restrict__ ai,
                  const long long* __restrict__ b, const int* __restrict__ bi,
                  long long* __restrict__ out_keys, int* __restrict__ out_idx,
                  int rows, int wa, int wb) {
    const int w = wa + wb;
    for (int r = blockIdx.y; r < rows; r += gridDim.y) {
        const long long* ar = a + (long long)r * wa;
        const long long* br = b + (long long)r * wb;
        const int* air = ai + (long long)r * wa;
        const int* bir = bi + (long long)r * wb;
        long long* ok = out_keys + (long long)r * w;
        int* oi = out_idx + (long long)r * w;
        for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < w;
             g += gridDim.x * blockDim.x) {
            long long key;
            int idx, pos;
            if (g < wa) {
                key = ar[g];
                idx = air[g];
                pos = g + lower_bound(br, wb, key);
            } else {
                const int j = g - wa;
                key = br[j];
                idx = bir[j];
                pos = j + upper_bound(ar, wa, key);
            }
            ok[pos] = key;
            oi[pos] = idx;
        }
    }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
merge_kway_kernel(const long long* __restrict__ keys, RunOffsets offs, int k,
                  long long* __restrict__ out_keys, int* __restrict__ out_idx) {
    __shared__ int at[MAX_RUNS + 1];
    __shared__ long long staged[STAGED ? SMEM_KEYS : 1];
    const int n = offs.at[k];
    for (int i = threadIdx.x; i <= k; i += blockDim.x) at[i] = offs.at[i];
    if constexpr (STAGED) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) staged[i] = keys[i];
    }
    __syncthreads();
    const long long* src = STAGED ? staged : keys;
    for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n;
         g += gridDim.x * blockDim.x) {
        // the run holding g: the last r with at[r] <= g (empty runs have
        // at[r] == at[r + 1] and are passed over)
        int r = 0, hi = k;
        while (hi - r > 1) {
            const int mid = (r + hi) >> 1;
            if (at[mid] <= g) r = mid; else hi = mid;
        }
        const long long key = src[g];
        int pos = g - at[r];
        for (int s = 0; s < k; ++s) {
            const int len = at[s + 1] - at[s];
            if (s < r) pos += upper_bound(src + at[s], len, key);
            else if (s > r) pos += lower_bound(src + at[s], len, key);
        }
        out_keys[pos] = key;
        out_idx[pos] = g;
    }
}

}  // namespace

// a: (rows, wa) int64 ascending per row, ai: (rows, wa) int32;
// b: (rows, wb), bi likewise; out_keys/out_idx: (rows, wa + wb).
extern "C" int merge_runs(const long long* a, const int* ai,
                          const long long* b, const int* bi,
                          long long* out_keys, int* out_idx, int rows, int wa,
                          int wb, void* stream) {
    const int w = wa + wb;
    if (rows <= 0 || w <= 0) return (int)cudaSuccess;
    int gx = (w + THREADS - 1) / THREADS;
    if (gx > 1024) gx = 1024;
    const int gy = rows < 65535 ? rows : 65535;
    merge_runs_kernel<<<dim3(gx, gy), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        a, ai, b, bi, out_keys, out_idx, rows, wa, wb);
    return (int)cudaGetLastError();
}

// keys: the k runs concatenated (int64, each run ascending); offsets: HOST
// memory, k + 1 ascending ints from 0 (run r is keys[offsets[r] ..
// offsets[r + 1])), 1 <= k <= 64; out_keys (int64) / out_idx (int32):
// offsets[k] entries each, out_idx the position in `keys`.
extern "C" int merge_runs_kway(const long long* keys, const int* offsets,
                               int k, long long* out_keys, int* out_idx,
                               void* stream) {
    if (k < 1 || k > MAX_RUNS) return (int)cudaErrorInvalidValue;
    RunOffsets offs;
    for (int r = 0; r <= k; ++r) offs.at[r] = offsets[r];
    const int n = offs.at[k];
    if (n <= 0) return (int)cudaSuccess;
    int grid = (n + THREADS - 1) / THREADS;
    if (grid > 1024) grid = 1024;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= SMEM_KEYS)
        merge_kway_kernel<true><<<grid, THREADS, 0, s>>>(keys, offs, k,
                                                         out_keys, out_idx);
    else
        merge_kway_kernel<false><<<grid, THREADS, 0, s>>>(keys, offs, k,
                                                          out_keys, out_idx);
    return (int)cudaGetLastError();
}
