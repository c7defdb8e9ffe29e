// Bucket probe of the hash lookup unit: fixed-slot open buckets.
//
// Replaces the TPU kernels `_probe_kernel` / `probe_table` and
// `_probe_sharded_kernel` / `probe_table_sharded`
// (kernels/hash_probe/hash_probe.py of the JAX package). For each query q:
// bucket = q mod n_buckets, sign-corrected (C's % truncates toward zero
// like the TPU's `lax.rem`, so a negative remainder gets n_buckets added
// back); compare all `slots` keys of the bucket row with q; return the
// largest value among the hits, or `default` when nothing hits. Keys are
// unique, so a hit is normally one slot; the maximum keeps the result
// exact for a query equal to the free-slot key EMPTY = int32.min, which
// hits every free slot (value 0) - the TPU kernel's answer too. Queries are
// S stacked rows of `width` (one island each, all against one shared
// table); a flat query vector is the S = 1 case.
//
// What bounds it on an H100: bytes and latency. Each query reads 4 bytes
// and writes 4; its bucket row (slots keys + slots values, slots a
// multiple of 4, usually 4 or 8) is a dependent random read. The TPU
// kernel holds the whole table in VMEM; here the table stays in global
// memory and is read through L2 (a dictionary's table is a few hundred KB
// at most, so it stays L2-resident across the launch). One thread per
// query, 16-byte loads of the bucket row when the table allows them, and
// no shared memory, so occupancy hides the gather latency.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void slot(int key, int val, int q, bool& found,
                                     int& best) {
    if (key == q) {
        found = true;
        best = max(best, val);
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const int* __restrict__ queries, long long width,
             const int* __restrict__ keys, const int* __restrict__ vals,
             int n_buckets, int slots, int dflt, int* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= width) return;
    const long long at = (long long)blockIdx.y * width + i;   // shard row
    const int q = queries[at];
    int b = q % n_buckets;
    if (b < 0) b += n_buckets;
    const long long row = (long long)b * slots;
    bool found = false;
    int best = INT_MIN;
    if (VEC) {
        const int4* k4 = reinterpret_cast<const int4*>(keys + row);
        const int4* v4 = reinterpret_cast<const int4*>(vals + row);
        for (int s = 0; s < (slots >> 2); ++s) {
            const int4 k = k4[s];
            const int4 v = v4[s];
            slot(k.x, v.x, q, found, best);
            slot(k.y, v.y, q, found, best);
            slot(k.z, v.z, q, found, best);
            slot(k.w, v.w, q, found, best);
        }
    } else {
        for (int s = 0; s < slots; ++s)
            slot(keys[row + s], vals[row + s], q, found, best);
    }
    out[at] = found ? best : dflt;
}

inline bool aligned(const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

}  // namespace

// queries/out: (n_shards, width) int32 row-major; keys/vals: (n_buckets,
// slots) int32 row-major.
extern "C" int hash_probe(const int* queries, int n_shards, long long width,
                          const int* keys, const int* vals, int n_buckets,
                          int slots, int dflt, int* out, void* stream) {
    if (n_shards <= 0 || width <= 0) return (int)cudaSuccess;
    if (n_buckets <= 0 || slots <= 0 || n_shards > 65535)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (width + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bool vec = slots % 4 == 0 && aligned(keys, 16) && aligned(vals, 16);
    dim3 grid((unsigned)blocks, (unsigned)n_shards);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec)
        probe_kernel<true><<<grid, THREADS, 0, s>>>(
            queries, width, keys, vals, n_buckets, slots, dflt, out);
    else
        probe_kernel<false><<<grid, THREADS, 0, s>>>(
            queries, width, keys, vals, n_buckets, slots, dflt, out);
    return (int)cudaGetLastError();
}
