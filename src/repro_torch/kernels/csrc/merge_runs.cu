// Row-wise merge of two ascending runs of 64-bit keys with an int32
// source-index lane.
//
// Replaces the TPU kernel `_merge_kernel` / `_merge_pallas` /
// `bitonic_merge_pair` (kernels/merge_runs/merge_runs.py of the JAX
// package): the merge unit that turns the per-thread update logs into the
// commit-ordered final log, and merges dictionaries. The TPU version
// concatenates A with reversed B and runs log2(2w) compare-exchange stages
// over (hi, lo) int32 key lanes, padded to a power of two of at least 128.
//
// What bounds it on an H100: bytes, 12 per entry in and 12 out (8-byte key
// + 4-byte index); a ship batch is at most 1024 entries, so in practice
// the launch itself. The design therefore does the whole merge in one pass
// with no padding and no stages: keys are compared as native int64, and
// every entry finds its output slot by itself - its own index plus its
// rank in the other run (lower bound for A, upper bound for B, so equal
// keys keep A first and the merge is stable). Each entry is read once and
// written once; the binary searches hit the other run in L1/L2. Rows are
// independent (blockIdx.y).

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int THREADS = 256;

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
