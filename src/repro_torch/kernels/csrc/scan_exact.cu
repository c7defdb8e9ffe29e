// Exact multi-predicate scan over dictionary-encoded columns, with an
// optional self-join lane and a leading shard axis.
//
// Replaces the TPU kernels `_scan_exact_kernel` /
// `scan_filter_agg_exact_kernel` and `_scan_exact_sharded_kernel` /
// `scan_filter_agg_sharded_kernel` (kernels/dict_ops/dict_ops.py of the JAX
// package) and the two-call composites `_join_scan_pallas` and
// `_join_scan_sharded_pallas` (kernels/hash_probe/ops.py): for each of Q
// code ranges [lo, hi) it returns sum(adict[acodes]) and the count over rows
// with lo <= fcodes < hi and fvalid, and with the join lane also
// sum(rcount[jcodes]) over the rows that are jvalid too. The columns are
// S stacked shards of `width` rows each (one analytical island per shard,
// padded slots carry valid = 0); each shard gets its own partials. A flat
// column is the S = 1 case.
//
// What bounds it on an H100: bytes. Each row costs 4 (fcodes) + 4 (acodes)
// + 1 (fvalid) bytes, plus 4 + 1 with the join lane; the arithmetic is a
// few integer compares and adds per row, far below the card's integer
// rate. So the design reads every column exactly once (the join lane rides
// the same pass, so fcodes/fvalid are not read twice as in the two-call
// composite), with 16-byte loads where the pointers allow it (a shard
// whose first row is not on a 16-byte boundary - any shard after the first
// when the width is not a multiple of 4 - reads its first rows one at a
// time up to the boundary, then 16 bytes at a time), and keeps
// everything else out of device memory: the per-predicate sums live in
// registers as native 64-bit integers, and the dictionary (a few hundred KB
// at most, shared by every block) is gathered through L2, only for rows
// that pass the mask (a padded slot's code 0 is never looked up, so an
// empty dictionary is legal). The TPU kernel holds the dictionary in VMEM;
// staging it in shared memory was measured on an H100 and dropped: every
// block has to stage the whole dictionary for itself, which buys nothing
// for a small dictionary and costs occupancy for a large one (PERF.md has
// the times). The TPU grid walks the shards in order; here the shard is
// the grid's z index, so every island's blocks run at once. Blocks run in
// any order: each reduces with warp shuffles and shared-memory atomics and
// adds its partial to its shard's output with one 64-bit atomicAdd per
// (block, predicate, lane) - integer addition is associative, so the
// result is exact and the same from run to run. Up to QT predicates are
// answered per pass over the rows; a larger group takes one grid slice
// (blockIdx.y) per QT predicates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 8;         // predicates held in registers per pass
constexpr int THREADS = 512;

template <bool JOIN>
struct Acc {
    long long sum[QT];
    long long jsum[QT];
    int cnt[QT];              // one thread sees fewer than 2^31 rows
    int lo[QT];
    int hi[QT];

    __device__ __forceinline__ void row(int fc, int ac, unsigned fv, int jc,
                                        unsigned jv, const int* ad,
                                        const int* rc) {
        if (!fv) return;
        unsigned hit = 0;
#pragma unroll
        for (int t = 0; t < QT; ++t)
            hit |= (unsigned)(fc >= lo[t] && fc < hi[t]) << t;
        if (!hit) return;
        const long long v = ad[ac];
        long long w = 0;
        if (JOIN) {
            if (jv) w = rc[jc];
        }
#pragma unroll
        for (int t = 0; t < QT; ++t) {
            if ((hit >> t) & 1u) {
                sum[t] += v;
                cnt[t] += 1;
                if (JOIN) jsum[t] += w;
            }
        }
    }
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Two blocks per SM for the scan alone (at most 64 registers a thread, as
// the flat kernel used before the shard axis); the join lane needs more
// registers than that and keeps one.
template <bool JOIN, bool VEC>
__global__ void __launch_bounds__(THREADS, JOIN ? 1 : 2)
scan_exact_kernel(const int* __restrict__ fcodes,
                  const int* __restrict__ acodes,
                  const uint8_t* __restrict__ fvalid,
                  const int* __restrict__ adict,
                  const int* __restrict__ bounds, int nq,
                  const int* __restrict__ jcodes,
                  const uint8_t* __restrict__ jvalid,
                  const int* __restrict__ rcount, long long n,
                  unsigned long long* __restrict__ out) {
    __shared__ unsigned long long red[3 * QT];
    constexpr int lanes = JOIN ? 3 : 2;

    // this block's shard: n rows at a stride of n
    const long long base = (long long)blockIdx.z * n;
    // rows of this shard before its first 16-byte boundary (the column
    // pointers themselves are aligned when VEC)
    long long head = VEC ? (4 - (base & 3)) & 3 : 0;
    if (head > n) head = n;
    fcodes += base;
    acodes += base;
    fvalid += base;
    if (JOIN) {
        jcodes += base;
        jvalid += base;
    }

    const int* ad = adict;
    const int* rc = rcount;
    if (threadIdx.x < 3 * QT) red[threadIdx.x] = 0ull;
    __syncthreads();

    const int q0 = blockIdx.y * QT;
    Acc<JOIN> acc;
#pragma unroll
    for (int t = 0; t < QT; ++t) {
        const bool live = q0 + t < nq;
        acc.lo[t] = live ? bounds[2 * (q0 + t)] : 0;
        acc.hi[t] = live ? bounds[2 * (q0 + t) + 1] : 0;   // empty range
        acc.sum[t] = 0;
        acc.jsum[t] = 0;
        acc.cnt[t] = 0;
    }

    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * blockDim.x;
    if (VEC) {
        if (tid < head)
            acc.row(fcodes[tid], acodes[tid], fvalid[tid],
                    JOIN ? jcodes[tid] : 0, JOIN ? jvalid[tid] : 0u, ad, rc);
        const long long n4 = (n - head) >> 2;
        const int4* f4 = reinterpret_cast<const int4*>(fcodes + head);
        const int4* a4 = reinterpret_cast<const int4*>(acodes + head);
        const uchar4* v4 = reinterpret_cast<const uchar4*>(fvalid + head);
        const int4* j4 =
            JOIN ? reinterpret_cast<const int4*>(jcodes + head) : nullptr;
        const uchar4* w4 =
            JOIN ? reinterpret_cast<const uchar4*>(jvalid + head) : nullptr;
        for (long long g = tid; g < n4; g += nthreads) {
            const int4 f = f4[g];
            const int4 a = a4[g];
            const uchar4 v = v4[g];
            int4 j = make_int4(0, 0, 0, 0);
            uchar4 w = make_uchar4(0, 0, 0, 0);
            if (JOIN) {
                j = j4[g];
                w = w4[g];
            }
            acc.row(f.x, a.x, v.x, j.x, w.x, ad, rc);
            acc.row(f.y, a.y, v.y, j.y, w.y, ad, rc);
            acc.row(f.z, a.z, v.z, j.z, w.z, ad, rc);
            acc.row(f.w, a.w, v.w, j.w, w.w, ad, rc);
        }
        // ragged tail (fewer than 4 rows), masked here rather than padded
        const long long i = head + (n4 << 2) + tid;
        if (i < n)
            acc.row(fcodes[i], acodes[i], fvalid[i], JOIN ? jcodes[i] : 0,
                    JOIN ? jvalid[i] : 0u, ad, rc);
    } else {
        for (long long i = tid; i < n; i += nthreads)
            acc.row(fcodes[i], acodes[i], fvalid[i], JOIN ? jcodes[i] : 0,
                    JOIN ? jvalid[i] : 0u, ad, rc);
    }

    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int t = 0; t < QT; ++t) {
        const long long s = warp_sum(acc.sum[t]);
        const long long c = warp_sum((long long)acc.cnt[t]);
        long long js = 0;
        if (JOIN) js = warp_sum(acc.jsum[t]);
        if (lane == 0) {
            if (s) atomicAdd(&red[t], (unsigned long long)s);
            if (c) atomicAdd(&red[QT + t], (unsigned long long)c);
            if (JOIN && js) atomicAdd(&red[2 * QT + t], (unsigned long long)js);
        }
    }
    __syncthreads();
    if (threadIdx.x < lanes * QT) {
        const int which = threadIdx.x / QT;
        const int t = threadIdx.x % QT;
        const unsigned long long v = red[which * QT + t];
        if (q0 + t < nq && v)   // the shard's partials start at lanes * nq
            atomicAdd(&out[((long long)blockIdx.z * lanes + which) * nq + q0
                           + t], v);
    }
}

inline bool aligned(const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

template <bool JOIN, bool VEC>
cudaError_t launch(const int* fcodes, const int* acodes, const uint8_t* fvalid,
                   const int* adict, const int* bounds, int nq,
                   const int* jcodes, const uint8_t* jvalid, const int* rcount,
                   int n_shards, long long width, unsigned long long* out,
                   cudaStream_t stream) {
    auto kern = scan_exact_kernel<JOIN, VEC>;
    cudaError_t err;
    int dev = 0, sms = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kern, THREADS, 0)) != cudaSuccess)
        return err;
    if (occ < 1) return cudaErrorLaunchOutOfResources;
    // as many blocks as the card holds at once, shared among the shards
    const long long per_block = (long long)THREADS * (VEC ? 4 : 1);
    long long want = (width + per_block - 1) / per_block;
    long long cap = (long long)sms * occ / n_shards;
    if (cap < 1) cap = 1;
    if (want > cap) want = cap;
    if (want < 1) want = 1;
    dim3 grid((unsigned)want, (unsigned)((nq + QT - 1) / QT),
              (unsigned)n_shards);
    kern<<<grid, THREADS, 0, stream>>>(fcodes, acodes, fvalid, adict, bounds,
                                       nq, jcodes, jvalid, rcount, width, out);
    return cudaGetLastError();
}

}  // namespace

// Columns are (n_shards, width) row-major; out: (n_shards, 2, nq) int64
// zeros without the join lane (sums, counts), (n_shards, 3, nq) with it
// (sums, counts, join sums). jcodes == nullptr selects no join lane.
extern "C" int scan_exact(const int* fcodes, const int* acodes,
                          const uint8_t* fvalid, const int* adict,
                          const int* bounds, int nq, const int* jcodes,
                          const uint8_t* jvalid, const int* rcount,
                          int n_shards, long long width,
                          unsigned long long* out, void* stream) {
    if (n_shards <= 0 || width <= 0 || nq <= 0) return (int)cudaSuccess;
    if (n_shards > 65535 || (nq + QT - 1) / QT > 65535)
        return (int)cudaErrorInvalidValue;
    const bool join = jcodes != nullptr;
    // 16-byte loads from aligned columns; each shard steps up to its own
    // first aligned row in the kernel
    bool vec = aligned(fcodes, 16) && aligned(acodes, 16) && aligned(fvalid, 4);
    if (join) vec = vec && aligned(jcodes, 16) && aligned(jvalid, 4);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
#define GO(J, V)                                                            \
    launch<J, V>(fcodes, acodes, fvalid, adict, bounds, nq, jcodes, jvalid, \
                 rcount, n_shards, width, out, s)
    if (join)
        err = vec ? GO(true, true) : GO(true, false);
    else
        err = vec ? GO(false, true) : GO(false, false);
#undef GO
    return (int)err;
}

// The text of a CUDA error code, for the Python side's exceptions.
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
