// Exact multi-predicate scan over dictionary-encoded columns, with an
// optional self-join lane.
//
// Replaces the TPU kernels `_scan_exact_kernel` /
// `scan_filter_agg_exact_kernel` (kernels/dict_ops/dict_ops.py of the JAX
// package) and the two-call composite `_join_scan_pallas`
// (kernels/hash_probe/ops.py): for each of Q code ranges [lo, hi) it
// returns sum(adict[acodes]) and the count over rows with
// lo <= fcodes < hi and fvalid, and with the join lane also
// sum(rcount[jcodes]) over the rows that are jvalid too.
//
// What bounds it on an H100: bytes. Each row costs 4 (fcodes) + 4 (acodes)
// + 1 (fvalid) bytes, plus 4 + 1 with the join lane; the arithmetic is a
// few integer compares and adds per row, far below the card's integer
// rate. So the design reads every column exactly once (the join lane rides
// the same pass, so fcodes/fvalid are not read twice as in the two-call
// composite), with 16-byte loads where the pointers allow it, and keeps
// everything else out of device memory: the per-predicate sums live in
// registers as native 64-bit integers, and the dictionary (a few hundred KB
// at most, shared by every block) is gathered through L2. The TPU kernel
// holds the dictionary in VMEM; staging it in shared memory was measured on
// an H100 and dropped: every block has to stage the whole dictionary for
// itself, which buys nothing for a small dictionary and costs occupancy for
// a large one (PERF.md has the times). Blocks run in any order: each reduces
// with warp shuffles and shared-memory atomics and adds its partial to the
// output with one 64-bit atomicAdd per (block, predicate, lane) - integer
// addition is associative, so the result is exact and the same from run to
// run. Up to QT predicates are answered per pass over the rows; a larger
// group takes one grid slice (blockIdx.y) per QT predicates.

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

template <bool JOIN, bool VEC>
__global__ void __launch_bounds__(THREADS)
scan_exact_kernel(const int* __restrict__ fcodes,
                  const int* __restrict__ acodes,
                  const uint8_t* __restrict__ fvalid,
                  const int* __restrict__ adict, int k,
                  const int* __restrict__ bounds, int nq,
                  const int* __restrict__ jcodes,
                  const uint8_t* __restrict__ jvalid,
                  const int* __restrict__ rcount, int kj, long long n,
                  unsigned long long* __restrict__ out) {
    __shared__ unsigned long long red[3 * QT];

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
        const long long n4 = n >> 2;
        const int4* f4 = reinterpret_cast<const int4*>(fcodes);
        const int4* a4 = reinterpret_cast<const int4*>(acodes);
        const uchar4* v4 = reinterpret_cast<const uchar4*>(fvalid);
        const int4* j4 = reinterpret_cast<const int4*>(jcodes);
        const uchar4* w4 = reinterpret_cast<const uchar4*>(jvalid);
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
        // ragged tail (n % 4 rows), masked here rather than padded
        const long long i = (n4 << 2) + tid;
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
    const int lanes = JOIN ? 3 : 2;
    if (threadIdx.x < lanes * QT) {
        const int which = threadIdx.x / QT;
        const int t = threadIdx.x % QT;
        const unsigned long long v = red[which * QT + t];
        if (q0 + t < nq && v)
            atomicAdd(&out[(long long)which * nq + q0 + t], v);
    }
}

inline bool aligned(const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

template <bool JOIN, bool VEC>
cudaError_t launch(const int* fcodes, const int* acodes, const uint8_t* fvalid,
                   const int* adict, int k, const int* bounds, int nq,
                   const int* jcodes, const uint8_t* jvalid, const int* rcount,
                   int kj, long long n, unsigned long long* out,
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
    const long long per_block = (long long)THREADS * (VEC ? 4 : 1);
    long long want = (n + per_block - 1) / per_block;
    const long long cap = (long long)sms * occ;
    if (want > cap) want = cap;
    if (want < 1) want = 1;
    dim3 grid((unsigned)want, (unsigned)((nq + QT - 1) / QT));
    kern<<<grid, THREADS, 0, stream>>>(fcodes, acodes, fvalid, adict, k,
                                       bounds, nq, jcodes, jvalid, rcount, kj,
                                       n, out);
    return cudaGetLastError();
}

}  // namespace

// out: (2, nq) int64 zeros without the join lane (sums, counts), (3, nq)
// with it (sums, counts, join sums). jcodes == nullptr selects no join lane.
extern "C" int scan_exact(const int* fcodes, const int* acodes,
                          const uint8_t* fvalid, const int* adict, int k,
                          const int* bounds, int nq, const int* jcodes,
                          const uint8_t* jvalid, const int* rcount, int kj,
                          long long n, unsigned long long* out,
                          void* stream) {
    if (n <= 0 || nq <= 0) return (int)cudaSuccess;
    const bool join = jcodes != nullptr;
    bool vec = aligned(fcodes, 16) && aligned(acodes, 16) && aligned(fvalid, 4);
    if (join) vec = vec && aligned(jcodes, 16) && aligned(jvalid, 4);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
#define GO(J, V)                                                            \
    launch<J, V>(fcodes, acodes, fvalid, adict, k, bounds, nq, jcodes,      \
                 jvalid, rcount, kj, n, out, s)
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
