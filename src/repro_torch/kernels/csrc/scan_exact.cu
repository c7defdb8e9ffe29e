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
//
// The mesh scans (`scan_exact_islands`). They replace `_mesh_scan_call` /
// `scan_filter_agg_mesh` (kernels/dict_ops/ops.py) and `_mesh_join_call` /
// `scan_filter_agg_join_mesh` (kernels/hash_probe/ops.py), which run the
// sharded scan on every island of a device mesh in one `shard_map` and
// psum the partials. Here an island is a flat column of its own on its own
// device; the islands that share a device (up to MAX_ISLANDS) are one
// launch of the same row walk with the island as the grid's z index. Their
// column pointers, lengths, dictionaries and histograms travel by value in
// the launch's parameters (a table of about 1 KB), so nothing is copied to
// the device for the launch, islands of any widths and offsets share it
// (each island finds its own first 16-byte boundary; blocks past an
// island's rows leave at once), and every island's blocks add into ONE
// (lanes, Q) output per device with the same 64-bit atomics: islands that
// share a card cost one launch and no reduction on the host.
//
// The correction lane (the delta store). It replaces the raw-value scan
// `_scan_values_kernel` / `scan_values_agg_exact_kernel`
// (kernels/dict_ops/dict_ops.py) and the fused composites built on it:
// `_scan_group_kernel_body` / `scan_filter_agg_group`, its sharded sibling
// `_scan_group_sharded_kernel_body`, `_scan_values_delta_kernel_body` /
// `scan_values_delta` (kernels/dict_ops/ops.py) and
// `_join_group_pallas_body` / `scan_filter_agg_join_group`
// (kernels/hash_probe/ops.py). A correction stack is a (6, nr) int32 array
// of overlay rows [fv_eff, av_eff, valid_eff, fv_base, av_base,
// valid_base]; for each of Q INCLUSIVE raw-value ranges [lo, hi] the lane
// adds [lo <= fv_eff <= hi and valid_eff] * av_eff minus the same for the
// base triple to a sum, and the difference of the two indicators to a
// count. Integer subtraction is exact, so one signed delta accumulator
// stands where the TPU composites ran an effective and a base scan and
// subtracted their partials on the host. The lane is one more z slice of
// the same grid, after the S shard slices: its blocks walk the stack(s)
// and add their partial to output row S, beside the shards' rows. So a
// query group on the delta plane is one launch: the base scan (flat or
// sharded) plus the lane over the aggregate stack into the (sum, count)
// lanes and, with the join lane, the lane over the join-weight stack into
// the join sum. With no shard slices the lane runs alone (the values
// delta), and a 3-row stack holding only the effective triple is the plain
// raw-value scan. Stacks are read one int32 a thread per row, coalesced,
// with no padding: a stack is a few thousand rows (bounded by the
// compaction capacity) against the base column's millions, so its bytes
// (24 a row) add a fraction of a percent to the scan's.

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

// Lane 0 of each warp adds the warp's total to the block's shared partial.
__device__ __forceinline__ void add_warp(unsigned long long* red,
                                         long long v) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(red, (unsigned long long)v);
}

// One correction pass of this block over a (3 or 6, nr) stack: per
// predicate, the effective row's contribution minus the base row's, into
// red[sum_lane] and (cnt_lane >= 0) red[cnt_lane]. A 3-row stack has no
// base triple.
__device__ __forceinline__ void corr_pass(const int* __restrict__ stack,
                                          long long nr, bool has_base,
                                          const int* __restrict__ vbounds,
                                          int nq, int q0,
                                          unsigned long long* red,
                                          int sum_lane, int cnt_lane) {
    long long sum[QT];
    int cnt[QT], lo[QT], hi[QT];
#pragma unroll
    for (int t = 0; t < QT; ++t) {
        const bool live = q0 + t < nq;
        lo[t] = live ? vbounds[2 * (q0 + t)] : 1;        // 1 > 0: empty
        hi[t] = live ? vbounds[2 * (q0 + t) + 1] : 0;
        sum[t] = 0;
        cnt[t] = 0;
    }
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < nr; i += step) {
        const int fe = stack[i], ae = stack[nr + i], ve = stack[2 * nr + i];
        int fb = 0, ab = 0, vb = 0;
        if (has_base) {
            fb = stack[3 * nr + i];
            ab = stack[4 * nr + i];
            vb = stack[5 * nr + i];
        }
#pragma unroll
        for (int t = 0; t < QT; ++t) {
            const bool e = ve != 0 && fe >= lo[t] && fe <= hi[t];
            const bool b = vb != 0 && fb >= lo[t] && fb <= hi[t];
            sum[t] += (e ? (long long)ae : 0ll) - (b ? (long long)ab : 0ll);
            cnt[t] += (int)e - (int)b;
        }
    }
#pragma unroll
    for (int t = 0; t < QT; ++t) {
        add_warp(&red[sum_lane * QT + t], sum[t]);
        if (cnt_lane >= 0) add_warp(&red[cnt_lane * QT + t], (long long)cnt[t]);
    }
}

// This block's share of one column's rows (a shard, or an island): n rows
// at fcodes/acodes/fvalid (and jcodes/jvalid with the join lane), the
// thread's rows strided over the grid's x dimension. With VEC the first
// `head` rows are read one a thread, up to the 16-byte boundary, then 16
// bytes (4 rows) a thread-step, the ragged tail one a thread.
template <bool JOIN, bool VEC>
__device__ __forceinline__ void scan_rows(Acc<JOIN>& acc,
                                          const int* __restrict__ fcodes,
                                          const int* __restrict__ acodes,
                                          const uint8_t* __restrict__ fvalid,
                                          const int* __restrict__ jcodes,
                                          const uint8_t* __restrict__ jvalid,
                                          long long n, long long head,
                                          const int* __restrict__ ad,
                                          const int* __restrict__ rc) {
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
}

// The predicates of this block's grid slice (blockIdx.y) into acc.
template <bool JOIN>
__device__ __forceinline__ void init_acc(Acc<JOIN>& acc,
                                         const int* __restrict__ bounds,
                                         int nq, int q0) {
#pragma unroll
    for (int t = 0; t < QT; ++t) {
        const bool live = q0 + t < nq;
        acc.lo[t] = live ? bounds[2 * (q0 + t)] : 0;
        acc.hi[t] = live ? bounds[2 * (q0 + t) + 1] : 0;   // empty range
        acc.sum[t] = 0;
        acc.jsum[t] = 0;
        acc.cnt[t] = 0;
    }
}

template <bool JOIN>
__device__ __forceinline__ void reduce_acc(const Acc<JOIN>& acc,
                                           unsigned long long* red) {
#pragma unroll
    for (int t = 0; t < QT; ++t) {
        add_warp(&red[t], acc.sum[t]);
        add_warp(&red[QT + t], (long long)acc.cnt[t]);
        if (JOIN) add_warp(&red[2 * QT + t], acc.jsum[t]);
    }
}

// The block's partials (red, after a __syncthreads) added into a (lanes, nq)
// output: one 64-bit atomicAdd per (lane, predicate).
template <int LANES>
__device__ __forceinline__ void add_block(const unsigned long long* red,
                                          unsigned long long* out, int nq,
                                          int q0) {
    if (threadIdx.x < LANES * QT) {
        const int which = threadIdx.x / QT;
        const int t = threadIdx.x % QT;
        const unsigned long long v = red[which * QT + t];
        if (q0 + t < nq && v) atomicAdd(&out[which * nq + q0 + t], v);
    }
}

// Two blocks per SM for the scan alone (at most 64 registers a thread, as
// the flat kernel used before the shard axis); the join lane needs more
// registers than that and keeps one. With CORR the grid has one more z
// slice than shards: the correction lane's (see the header).
template <bool JOIN, bool VEC, bool CORR>
__global__ void __launch_bounds__(THREADS, JOIN ? 1 : 2)
scan_exact_kernel(const int* __restrict__ fcodes,
                  const int* __restrict__ acodes,
                  const uint8_t* __restrict__ fvalid,
                  const int* __restrict__ adict,
                  const int* __restrict__ bounds, int nq,
                  const int* __restrict__ jcodes,
                  const uint8_t* __restrict__ jvalid,
                  const int* __restrict__ rcount, long long n,
                  const int* __restrict__ corr_a, long long nr_a,
                  int corr_base, const int* __restrict__ corr_j,
                  long long nr_j, const int* __restrict__ vbounds,
                  unsigned long long* __restrict__ out) {
    __shared__ unsigned long long red[3 * QT];
    constexpr int lanes = JOIN ? 3 : 2;
    const bool corr_slice = CORR && blockIdx.z == gridDim.z - 1;
    // blocks of the correction slice beyond the stacks' rows have nothing
    // to add (the whole block leaves together)
    if (corr_slice && (long long)blockIdx.x * blockDim.x >= nr_a &&
        (long long)blockIdx.x * blockDim.x >= nr_j)
        return;
    if (threadIdx.x < 3 * QT) red[threadIdx.x] = 0ull;
    __syncthreads();
    const int q0 = blockIdx.y * QT;

    if (corr_slice) {
        corr_pass(corr_a, nr_a, corr_base != 0, vbounds, nq, q0, red, 0, 1);
        if (JOIN)   // join weights: only the sum delta, into the join sum
            corr_pass(corr_j, nr_j, true, vbounds, nq, q0, red, 2, -1);
    } else {
        // this block's shard: n rows at a stride of n
        const long long base = (long long)blockIdx.z * n;
        // rows of this shard before its first 16-byte boundary (the column
        // pointers themselves are aligned when VEC)
        long long head = VEC ? (4 - (base & 3)) & 3 : 0;
        if (head > n) head = n;
        Acc<JOIN> acc;
        init_acc(acc, bounds, nq, q0);
        scan_rows<JOIN, VEC>(acc, fcodes + base, acodes + base, fvalid + base,
                             JOIN ? jcodes + base : nullptr,
                             JOIN ? jvalid + base : nullptr, n, head, adict,
                             rcount);
        reduce_acc(acc, red);
    }
    __syncthreads();
    // slice z's partials start at z * lanes * nq
    add_block<lanes>(red, out + (long long)blockIdx.z * lanes * nq, nq, q0);
}

// The mesh scans: up to MAX_ISLANDS islands of one device in one launch,
// each its own flat column (own pointers, own length, own dictionary and
// build-side histogram), the island the grid's z index. `head` is the
// island's rows before its first 16-byte boundary, -1 where its columns are
// not aligned alike (then it is read one row a thread).
constexpr int MAX_ISLANDS = 16;

struct Island {
    const int* fcodes;
    const int* acodes;
    const uint8_t* fvalid;
    const int* adict;
    const int* jcodes;
    const uint8_t* jvalid;
    const int* rcount;
    long long n;
    int head;
};

struct IslandTable {              // travels in the launch's parameters
    Island at[MAX_ISLANDS];
};

template <bool JOIN>
__global__ void __launch_bounds__(THREADS, JOIN ? 1 : 2)
scan_islands_kernel(const __grid_constant__ IslandTable tab,
                    const int* __restrict__ bounds, int nq,
                    unsigned long long* __restrict__ out) {
    __shared__ unsigned long long red[3 * QT];
    const Island& isl = tab.at[blockIdx.z];
    // an island narrower than the widest has blocks with no rows of its
    // own (the whole block leaves together)
    if ((long long)blockIdx.x * blockDim.x >= isl.n) return;
    if (threadIdx.x < 3 * QT) red[threadIdx.x] = 0ull;
    __syncthreads();
    const int q0 = blockIdx.y * QT;
    Acc<JOIN> acc;
    init_acc(acc, bounds, nq, q0);
    const long long head = isl.head < isl.n ? isl.head : isl.n;
    if (isl.head >= 0)
        scan_rows<JOIN, true>(acc, isl.fcodes, isl.acodes, isl.fvalid,
                              isl.jcodes, isl.jvalid, isl.n, head, isl.adict,
                              isl.rcount);
    else
        scan_rows<JOIN, false>(acc, isl.fcodes, isl.acodes, isl.fvalid,
                               isl.jcodes, isl.jvalid, isl.n, 0, isl.adict,
                               isl.rcount);
    reduce_acc(acc, red);
    __syncthreads();
    // every island of the launch adds into the one output
    add_block<JOIN ? 3 : 2>(red, out, nq, q0);
}

inline bool aligned(const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// an int32 column's row position modulo 4 (its 16-byte phase)
inline uintptr_t row_mod4(const int* p) {
    return (reinterpret_cast<uintptr_t>(p) >> 2) & 3;
}

template <bool JOIN, bool VEC, bool CORR>
cudaError_t launch(const int* fcodes, const int* acodes, const uint8_t* fvalid,
                   const int* adict, const int* bounds, int nq,
                   const int* jcodes, const uint8_t* jvalid, const int* rcount,
                   int n_shards, long long width, const int* corr_a,
                   long long nr_a, int corr_base, const int* corr_j,
                   long long nr_j, const int* vbounds,
                   unsigned long long* out, cudaStream_t stream) {
    auto kern = scan_exact_kernel<JOIN, VEC, CORR>;
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
    // as many blocks as the card holds at once, shared among the shards;
    // the correction slice gets as many, of which those past the stacks'
    // rows leave at once
    const long long per_block = (long long)THREADS * (VEC ? 4 : 1);
    long long want = n_shards > 0 ? (width + per_block - 1) / per_block : 0;
    if (CORR) {
        const long long nr = nr_a > nr_j ? nr_a : nr_j;
        const long long cw = (nr + THREADS - 1) / THREADS;
        if (cw > want) want = cw;
    }
    long long cap = (long long)sms * occ / (n_shards > 0 ? n_shards : 1);
    if (cap < 1) cap = 1;
    if (want > cap) want = cap;
    if (want < 1) want = 1;
    dim3 grid((unsigned)want, (unsigned)((nq + QT - 1) / QT),
              (unsigned)(n_shards + (CORR ? 1 : 0)));
    kern<<<grid, THREADS, 0, stream>>>(fcodes, acodes, fvalid, adict, bounds,
                                       nq, jcodes, jvalid, rcount, width,
                                       corr_a, nr_a, corr_base, corr_j, nr_j,
                                       vbounds, out);
    return cudaGetLastError();
}

// The island kernel's grid: as many blocks as the card holds at once,
// shared among the islands, each island's share sized for the widest.
template <bool JOIN>
cudaError_t launch_islands(const IslandTable& tab, int n_islands,
                           long long widest, const int* bounds, int nq,
                           unsigned long long* out, cudaStream_t stream) {
    auto kern = scan_islands_kernel<JOIN>;
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
    long long want = (widest + THREADS * 4LL - 1) / (THREADS * 4LL);
    long long cap = (long long)sms * occ / n_islands;
    if (cap < 1) cap = 1;
    if (want > cap) want = cap;
    if (want < 1) want = 1;
    dim3 grid((unsigned)want, (unsigned)((nq + QT - 1) / QT),
              (unsigned)n_islands);
    kern<<<grid, THREADS, 0, stream>>>(tab, bounds, nq, out);
    return cudaGetLastError();
}

}  // namespace

// Columns are (n_shards, width) row-major; out: (n_shards, 2, nq) int64
// zeros without the join lane (sums, counts), (n_shards, 3, nq) with it
// (sums, counts, join sums). jcodes == nullptr selects no join lane.
// vbounds != nullptr adds the correction lane and one output row after the
// shards' (out: (n_shards + 1, lanes, nq)): corr_a is the aggregate stack,
// (6, nr_a) int32, or (3, nr_a) with only the effective triple when
// corr_base is 0; corr_j the join-weight stack, (6, nr_j), with the join
// lane only; vbounds (nq, 2) inclusive raw-value ranges. n_shards == 0
// runs the lane alone.
extern "C" int scan_exact(const int* fcodes, const int* acodes,
                          const uint8_t* fvalid, const int* adict,
                          const int* bounds, int nq, const int* jcodes,
                          const uint8_t* jvalid, const int* rcount,
                          int n_shards, long long width, const int* corr_a,
                          long long nr_a, int corr_base, const int* corr_j,
                          long long nr_j, const int* vbounds,
                          unsigned long long* out, void* stream) {
    const bool corr = vbounds != nullptr;
    if (nq <= 0 || n_shards < 0) return (int)cudaSuccess;
    if (!corr && (n_shards == 0 || width <= 0)) return (int)cudaSuccess;
    if (width < 0 || nr_a < 0 || nr_j < 0) return (int)cudaErrorInvalidValue;
    if (n_shards + (corr ? 1 : 0) > 65535 || (nq + QT - 1) / QT > 65535)
        return (int)cudaErrorInvalidValue;
    const bool join = jcodes != nullptr;
    // 16-byte loads from aligned columns; each shard steps up to its own
    // first aligned row in the kernel
    bool vec = aligned(fcodes, 16) && aligned(acodes, 16) && aligned(fvalid, 4);
    if (join) vec = vec && aligned(jcodes, 16) && aligned(jvalid, 4);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
#define GO(J, V, C)                                                         \
    launch<J, V, C>(fcodes, acodes, fvalid, adict, bounds, nq, jcodes,      \
                    jvalid, rcount, n_shards, width, corr_a, nr_a,          \
                    corr_base, corr_j, nr_j, vbounds, out, s)
    if (corr) {
        if (join)
            err = vec ? GO(true, true, true) : GO(true, false, true);
        else
            err = vec ? GO(false, true, true) : GO(false, false, true);
    } else {
        if (join)
            err = vec ? GO(true, true, false) : GO(true, false, false);
        else
            err = vec ? GO(false, true, false) : GO(false, false, false);
    }
#undef GO
    return (int)err;
}

// The mesh scans' launch: `table` is HOST memory, ISLAND_FIELDS int64s per
// island - fcodes, acodes, fvalid, adict, jcodes, jvalid, rcount (device
// pointers; the last three 0 without the join lane) and the island's rows
// n - for 1 <= n_islands <= MAX_ISLANDS non-empty flat islands on the
// current device. Every island's (sums, counts[, join sums]) for the
// (nq, 2) code ranges `bounds` are added into the one zeroed (2|3, nq)
// int64 `out`.
constexpr int ISLAND_FIELDS = 8;

extern "C" int scan_exact_islands(const long long* table, int n_islands,
                                  const int* bounds, int nq, int join,
                                  unsigned long long* out, void* stream) {
    if (nq <= 0 || n_islands == 0) return (int)cudaSuccess;
    if (n_islands < 0 || n_islands > MAX_ISLANDS ||
        (nq + QT - 1) / QT > 65535)
        return (int)cudaErrorInvalidValue;
    IslandTable tab = {};
    long long widest = 0;
    for (int s = 0; s < n_islands; ++s) {
        const long long* f = table + s * ISLAND_FIELDS;
        Island& isl = tab.at[s];
        isl.fcodes = reinterpret_cast<const int*>(f[0]);
        isl.acodes = reinterpret_cast<const int*>(f[1]);
        isl.fvalid = reinterpret_cast<const uint8_t*>(f[2]);
        isl.adict = reinterpret_cast<const int*>(f[3]);
        isl.jcodes = join ? reinterpret_cast<const int*>(f[4]) : nullptr;
        isl.jvalid = join ? reinterpret_cast<const uint8_t*>(f[5]) : nullptr;
        isl.rcount = join ? reinterpret_cast<const int*>(f[6]) : nullptr;
        isl.n = f[7];
        if (isl.n <= 0 || (join && (!isl.jcodes || !isl.jvalid)))
            return (int)cudaErrorInvalidValue;
        if (isl.n > widest) widest = isl.n;
        // 16-byte loads from the first row at which every column is
        // aligned, where that is one row for all of them: an island is a
        // slice of a column at any offset, so only its rows' position
        // modulo 4 tells (int32 columns: address / 4, bytes: address)
        const uintptr_t m = row_mod4(isl.fcodes);
        bool same = aligned(isl.fcodes, 4) && aligned(isl.acodes, 4) &&
                    row_mod4(isl.acodes) == m &&
                    (reinterpret_cast<uintptr_t>(isl.fvalid) & 3) == m;
        if (join)
            same = same && aligned(isl.jcodes, 4) &&
                   row_mod4(isl.jcodes) == m &&
                   (reinterpret_cast<uintptr_t>(isl.jvalid) & 3) == m;
        isl.head = same ? (int)((4 - m) & 3) : -1;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(join ? launch_islands<true>(tab, n_islands, widest, bounds,
                                             nq, out, st)
                      : launch_islands<false>(tab, n_islands, widest, bounds,
                                              nq, out, st));
}

// The text of a CUDA error code, for the Python side's exceptions.
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
