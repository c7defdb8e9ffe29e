// Single-predicate scan-filter-sum in float32, with the count.
//
// Replaces the TPU kernel `_scan_kernel` / `scan_filter_agg_kernel`
// (kernels/dict_ops/dict_ops.py of the JAX package), the original fused
// scan that `scan_filter_agg(exact=False)` runs: over rows with lo <=
// fcodes < hi and valid, the float32 sum of dict[acodes] and the int32
// count. (The exact multi-predicate scan is `scan_exact.cu`; this one is
// kept apart so that kernel's registers and times stay as they are.)
//
// What bounds it on an H100: bytes, 4 (fcodes) + 4 (acodes) + 1 (valid)
// per row; the dictionary is gathered through L2, only for rows that pass
// the mask. The TPU grid walks row blocks in order and carries one sum in
// its output block. Here a grid-stride pass gives each block a float32
// partial sum and an int32 count (warp shuffles, then shared memory, in a
// fixed order), written to scratch, and a second one-block pass adds the
// partials in a fixed order: no atomics, so the sum is the same from run
// to run. It is taken in another order than the TPU's sequential one, so
// the float32 sums differ in their last bits (the count is exact). The
// reference pads the rows to its block with fcodes = int32.max and valid =
// 0, which match no predicate; here the grid stops at n instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T block_sum(T x, T* smem) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) smem[warp] = x;
    __syncthreads();
    x = 0;
    if (warp == 0) {
        if (lane < THREADS / 32) x = smem[lane];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_down_sync(0xffffffffu, x, o);
    }
    return x;                      // valid in thread 0
}

__global__ void __launch_bounds__(THREADS)
scan_float_partial(const int* __restrict__ fcodes, const int* __restrict__ acodes,
                   const uint8_t* __restrict__ valid, const int* __restrict__ dict,
                   long long n, int lo, int hi, float* __restrict__ psum,
                   int* __restrict__ pcnt) {
    __shared__ float ssum[THREADS / 32];
    __shared__ int scnt[THREADS / 32];
    float s = 0.f;
    int c = 0;
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += stride) {
        const int f = fcodes[i];
        if (f >= lo && f < hi && valid[i]) {
            s += (float)__ldg(dict + acodes[i]);
            c += 1;
        }
    }
    s = block_sum(s, ssum);
    c = block_sum(c, scnt);
    if (threadIdx.x == 0) {
        psum[blockIdx.x] = s;
        pcnt[blockIdx.x] = c;
    }
}

__global__ void __launch_bounds__(THREADS)
scan_float_final(const float* __restrict__ psum, const int* __restrict__ pcnt,
                 int n_parts, float* __restrict__ out_sum,
                 int* __restrict__ out_cnt) {
    __shared__ float ssum[THREADS / 32];
    __shared__ int scnt[THREADS / 32];
    float s = 0.f;
    int c = 0;
    for (int i = threadIdx.x; i < n_parts; i += THREADS) {
        s += psum[i];
        c += pcnt[i];
    }
    s = block_sum(s, ssum);
    c = block_sum(c, scnt);
    if (threadIdx.x == 0) {
        *out_sum = s;
        *out_cnt = c;
    }
}

}  // namespace

// fcodes, acodes (n,) int32; valid (n,) one byte a row; dict (k,) int32;
// psum / pcnt scratch of n_parts entries (the first pass's grid); out_sum
// (1,) float32 and out_cnt (1,) int32.
extern "C" int scan_float(const int* fcodes, const int* acodes,
                          const uint8_t* valid, const int* dict, long long n,
                          int lo, int hi, float* psum, int* pcnt, int n_parts,
                          float* out_sum, int* out_cnt, void* stream) {
    if (n_parts < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    scan_float_partial<<<n_parts, THREADS, 0, s>>>(fcodes, acodes, valid, dict,
                                                   n, lo, hi, psum, pcnt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_float_final<<<1, THREADS, 0, s>>>(psum, pcnt, n_parts, out_sum,
                                           out_cnt);
    return (int)cudaGetLastError();
}
