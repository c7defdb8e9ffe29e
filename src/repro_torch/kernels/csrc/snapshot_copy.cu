// Dirty-chunk snapshot copy: out[i] = dirty[i / block] ? src[i] : prev[i].
//
// Replaces the TPU kernel `_copy_kernel` / `snapshot_copy_kernel`
// (kernels/snapshot_copy/snapshot_copy.py of the JAX package), the copy
// unit with its tracking buffer: only chunks that changed since the last
// snapshot are fetched from the main replica, clean chunks are carried
// from the previous snapshot.
//
// What bounds it on an H100: bytes, 4 read + 4 written per row; there is
// no arithmetic. The design moves each byte once: a thread block takes a
// whole chunk and branches once on the chunk's flag, so a clean chunk never
// reads `src` and a dirty one never reads `prev` (an element-wise select
// would read both); loads and stores are 16 bytes per thread where the
// pointers are aligned; the ragged last chunk is masked here instead of
// padding the column to a multiple of the chunk size and trimming.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
snapshot_copy_kernel(const int* __restrict__ src, const int* __restrict__ prev,
                     const uint8_t* __restrict__ dirty, int* __restrict__ out,
                     long long n, int block, long long n_chunks) {
    for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
        const long long base = c * block;
        const int* from = (dirty[c] ? src : prev) + base;
        int* to = out + base;
        const long long left = n - base;
        const int len = left < block ? (int)left : block;
        int done = 0;
        if (VEC) {
            const int n4 = len >> 2;
            const int4* f4 = reinterpret_cast<const int4*>(from);
            int4* t4 = reinterpret_cast<int4*>(to);
            for (int i = threadIdx.x; i < n4; i += blockDim.x) t4[i] = f4[i];
            done = n4 << 2;
        }
        for (int i = done + threadIdx.x; i < len; i += blockDim.x)
            to[i] = from[i];
    }
}

inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int snapshot_copy(const int* src, const int* prev,
                             const uint8_t* dirty, int* out, long long n,
                             int block, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (block <= 0) return (int)cudaErrorInvalidValue;
    const long long n_chunks = (n + block - 1) / block;
    int dev = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    long long grid = (long long)sms * 8;
    if (grid > n_chunks) grid = n_chunks;
    const bool vec = aligned16(src) && aligned16(prev) && aligned16(out) &&
                     block % 4 == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec)
        snapshot_copy_kernel<true><<<(unsigned)grid, THREADS, 0, s>>>(
            src, prev, dirty, out, n, block, n_chunks);
    else
        snapshot_copy_kernel<false><<<(unsigned)grid, THREADS, 0, s>>>(
            src, prev, dirty, out, n, block, n_chunks);
    return (int)cudaGetLastError();
}
