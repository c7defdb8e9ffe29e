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
// composite), with 16-byte loads (4 rows a thread-step) wherever every
// column has its rows at one position modulo 4 (a shard or a view whose
// first row is not on a 16-byte boundary reads its first rows one at a
// time up to the boundary; columns at different positions are read a row
// at a time), and keeps everything else out of device memory: the
// per-predicate sums live in registers as native 64-bit integers, and the
// dictionary (a few hundred KB at most, shared by every block) is gathered
// through L1 and L2, only for rows that pass the mask (a padded slot's code
// 0 is never looked up, so an empty dictionary is legal). The TPU kernel
// holds the dictionary in VMEM; staging it in shared memory was measured on
// an H100 and dropped: every block has to stage the whole dictionary for
// itself, which buys nothing for a small dictionary and costs occupancy for
// a large one (PERF.md has the times). The TPU grid walks the shards in
// order; here the shard is the grid's z index, so every island's blocks run
// at once. Blocks run in any order: each reduces with warp shuffles and
// shared-memory atomics and adds its partial to its shard's output with one
// 64-bit atomicAdd per (block, predicate, lane) - integer addition is
// associative, so the result is exact and the same from run to run. Up to
// QT predicates are answered per pass over the rows; a larger group takes
// one grid slice (blockIdx.y) per QT predicates.
//
// The join lane reads 14 bytes a row and gathers twice, one gather
// depending on the other's mask. Reading the card's rate needs enough bytes
// in flight per SM to cover a device-memory latency (Little's law: about
// 3.35 TB/s x 0.6 us over 132 SMs, some 15 - 20 KB an SM), and the scan
// alone gets there with two blocks of 512 threads an SM and one 16-byte
// group a thread. The join lane did not: eight predicates' accumulators
// (56 registers, 7/8 of them dead at the paths' one predicate) held it to
// one block an SM, and each group waited out its streaming loads and then
// its gathers, so about 28 KB was spent over two latencies or more. So the
// join lane (`JoinAcc`, `join_rows`):
//   - holds QN predicates a pass, QN a template parameter the host picks
//     from the group's size: 1 for one predicate (about 7 registers of
//     accumulators), QT for more (grid y slices of QT as before); the
//     one-predicate instance fits 64 registers, so two blocks of 512 an SM;
//   - issues group g + 1's five streaming loads (three 16-byte, two
//     4-byte, evict-first) before group g's work, the next group held in
//     registers;
//   - computes a group's four row masks first, then issues its up to eight
//     gathers back to back, each predicated on its row's mask (and the
//     join's validity), and only then adds: no branch stands between a
//     group's loads and its gathers.
// The scan without the join lane keeps its own row loop (`Acc`,
// `scan_rows`): it reaches half the card's rate as it is. Its instance in
// the island kernel with the correction slice takes one predicate a pass
// for a one-predicate group (the join lane's rule): with eight, that
// instance spilled an accumulator at the 64-register cap; with one it
// reads 84 % of the card's rate (PERF.md has the times).
//
// The mesh scans (`scan_exact_islands`). They replace `_mesh_scan_call` /
// `scan_filter_agg_mesh` (kernels/dict_ops/ops.py) and `_mesh_join_call` /
// `scan_filter_agg_join_mesh` (kernels/hash_probe/ops.py), which run the
// sharded scan on every island of a device mesh in one `shard_map` and
// psum the partials. Here an island is a flat column of its own on its own
// device; the islands that share a device (up to MAX_ISLANDS) are one
// launch of the same row walk (the join lane's for the join scan) with the
// island as the grid's z index. Their column pointers, lengths,
// dictionaries and histograms travel by value in the launch's parameters (a
// table of about 1 KB), so nothing is copied to the device for the launch,
// islands of any widths and offsets share it (each island finds its own
// first 16-byte boundary; blocks past an island's rows leave at once), and
// every island's blocks add into ONE (lanes, Q) output per device with the
// same 64-bit atomics: islands that share a card cost one launch and no
// reduction on the host.
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
// subtracted their partials on the host. A stack is a few thousand rows
// (bounded by the compaction capacity) against the base column's
// millions: a launch of its own costs more than its bytes (24 a row), so
// the lane rides the scan launch beside it as one more z slice of that
// grid:
//   - `scan_exact_kernel` (flat or stacked columns, with or without the
//     join lane): after the shards' slices, its blocks walk the stack(s)
//     and add their partial to output row S, beside the shards' rows - the aggregate stack into the
//     (sum, count) lanes and, with the join lane, the join-weight stack
//     into the join sum (with the join lane's QN predicates a pass). So a
//     query group on the delta plane is one launch, on one island and on
//     stacked islands alike.
//   - `scan_islands_kernel` (the mesh): the same blocks, as the first
//     slice, on the launch of island 0's device, where the stacks live,
//     adding into the one (lanes, Q) output every island adds into. The stacks' pointers, rows
//     and the value bounds travel by value with the island table.
// Stacks are read one int32 a thread per row, coalesced, with no padding.
//
// The lane alone (`values_kernel`: no path of the port launches it, the
// reference's `scan_values_delta` / `scan_values_agg` as entries) is a
// kernel of its own, sized for a few thousand rows: a grid of one block
// per 256 rows, QN = 1 predicate a pass for one predicate (else QT), and
// only the live predicates' partials reduced - the launch itself is most
// of its time. A 3-row stack holding only the effective triple is the
// plain raw-value scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 8;         // predicates a wide pass holds in registers
constexpr int THREADS = 512;

// an int32 column's row position modulo 4 (its 16-byte phase)
__host__ __device__ __forceinline__ uintptr_t row_mod4(const int* p) {
    return (reinterpret_cast<uintptr_t>(p) >> 2) & 3;
}

// ---------------------------------------------------------------------------
// The scan without the join lane
// ---------------------------------------------------------------------------

// QN predicates a pass: QT everywhere but in the island kernel's instance
// with the correction slice, which takes one for a one-predicate group.
template <int QN = QT>
struct Acc {
    long long sum[QN];
    int cnt[QN];              // one thread sees fewer than 2^31 rows
    int lo[QN];
    int hi[QN];

    __device__ __forceinline__ void row(int fc, int ac, unsigned fv,
                                        const int* ad) {
        if (!fv) return;
        unsigned hit = 0;
#pragma unroll
        for (int t = 0; t < QN; ++t)
            hit |= (unsigned)(fc >= lo[t] && fc < hi[t]) << t;
        if (!hit) return;
        const long long v = ad[ac];
#pragma unroll
        for (int t = 0; t < QN; ++t) {
            if ((hit >> t) & 1u) {
                sum[t] += v;
                cnt[t] += 1;
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
// predicate (QN of them from q0), the effective row's contribution minus
// the base row's, into red[sum_lane] and (cnt_lane >= 0) red[cnt_lane]. A
// 3-row stack has no base triple.
template <int QN>
__device__ __forceinline__ void corr_pass(const int* __restrict__ stack,
                                          long long nr, bool has_base,
                                          const int* __restrict__ vbounds,
                                          int nq, int q0,
                                          unsigned long long* red,
                                          int sum_lane, int cnt_lane) {
    long long sum[QN];
    int cnt[QN], lo[QN], hi[QN];
#pragma unroll
    for (int t = 0; t < QN; ++t) {
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
        for (int t = 0; t < QN; ++t) {
            const bool e = ve != 0 && fe >= lo[t] && fe <= hi[t];
            const bool b = vb != 0 && fb >= lo[t] && fb <= hi[t];
            sum[t] += (e ? (long long)ae : 0ll) - (b ? (long long)ab : 0ll);
            cnt[t] += (int)e - (int)b;
        }
    }
#pragma unroll
    for (int t = 0; t < QN; ++t) {
        add_warp(&red[sum_lane * QN + t], sum[t]);
        if (cnt_lane >= 0) add_warp(&red[cnt_lane * QN + t], (long long)cnt[t]);
    }
}

// This block's share of one column's rows (a shard, or an island): n rows
// at fcodes/acodes/fvalid, the thread's rows strided over the grid's x
// dimension. With VEC the first `head` rows are read one a thread, up to
// the 16-byte boundary, then 16 bytes (4 rows) a thread-step, the ragged
// tail one a thread.
template <bool VEC, int QN>
__device__ __forceinline__ void scan_rows(Acc<QN>& acc,
                                          const int* __restrict__ fcodes,
                                          const int* __restrict__ acodes,
                                          const uint8_t* __restrict__ fvalid,
                                          long long n, long long head,
                                          const int* __restrict__ ad) {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nthreads = (long long)gridDim.x * blockDim.x;
    if (VEC) {
        if (tid < head) acc.row(fcodes[tid], acodes[tid], fvalid[tid], ad);
        const long long n4 = (n - head) >> 2;
        const int4* f4 = reinterpret_cast<const int4*>(fcodes + head);
        const int4* a4 = reinterpret_cast<const int4*>(acodes + head);
        const uchar4* v4 = reinterpret_cast<const uchar4*>(fvalid + head);
        for (long long g = tid; g < n4; g += nthreads) {
            const int4 f = f4[g];
            const int4 a = a4[g];
            const uchar4 v = v4[g];
            acc.row(f.x, a.x, v.x, ad);
            acc.row(f.y, a.y, v.y, ad);
            acc.row(f.z, a.z, v.z, ad);
            acc.row(f.w, a.w, v.w, ad);
        }
        // ragged tail (fewer than 4 rows), masked here rather than padded
        const long long i = head + (n4 << 2) + tid;
        if (i < n) acc.row(fcodes[i], acodes[i], fvalid[i], ad);
    } else {
        for (long long i = tid; i < n; i += nthreads)
            acc.row(fcodes[i], acodes[i], fvalid[i], ad);
    }
}

// The predicates of this block's grid slice (blockIdx.y) into acc.
template <int QN>
__device__ __forceinline__ void init_acc(Acc<QN>& acc,
                                         const int* __restrict__ bounds,
                                         int nq, int q0) {
#pragma unroll
    for (int t = 0; t < QN; ++t) {
        const bool live = q0 + t < nq;
        acc.lo[t] = live ? bounds[2 * (q0 + t)] : 0;
        acc.hi[t] = live ? bounds[2 * (q0 + t) + 1] : 0;   // empty range
        acc.sum[t] = 0;
        acc.cnt[t] = 0;
    }
}

template <int QN>
__device__ __forceinline__ void reduce_acc(const Acc<QN>& acc,
                                           unsigned long long* red) {
#pragma unroll
    for (int t = 0; t < QN; ++t) {
        add_warp(&red[t], acc.sum[t]);
        add_warp(&red[QN + t], (long long)acc.cnt[t]);
    }
}

// ---------------------------------------------------------------------------
// The join lane
// ---------------------------------------------------------------------------

// Four consecutive rows of the join lane's five columns.
struct JoinGroup {
    int4 f, a, j;
    uchar4 v, w;
};

template <int QN>
struct JoinAcc {
    long long sum[QN];
    long long jsum[QN];
    int cnt[QN];              // one thread sees fewer than 2^31 rows
    int lo[QN];
    int hi[QN];

    // The predicates of this block's grid slice (blockIdx.y).
    __device__ __forceinline__ void init(const int* __restrict__ bounds,
                                         int nq, int q0) {
#pragma unroll
        for (int t = 0; t < QN; ++t) {
            const bool live = q0 + t < nq;
            lo[t] = live ? bounds[2 * (q0 + t)] : 0;
            hi[t] = live ? bounds[2 * (q0 + t) + 1] : 0;   // empty range
            sum[t] = 0;
            jsum[t] = 0;
            cnt[t] = 0;
        }
    }

    // bit t: the row passes predicate t (0 for a row that is not fvalid)
    __device__ __forceinline__ unsigned hits(int fc, unsigned fv) const {
        unsigned m = 0;
#pragma unroll
        for (int t = 0; t < QN; ++t)
            m |= (unsigned)(fc >= lo[t] && fc < hi[t]) << t;
        return fv ? m : 0u;
    }

    // a row's gathered value v and join weight w (both 0 where m is 0)
    __device__ __forceinline__ void add(unsigned m, int v, int w) {
        if constexpr (QN == 1) {
            sum[0] += v;
            cnt[0] += (int)m;
            jsum[0] += w;
        } else {
#pragma unroll
            for (int t = 0; t < QN; ++t) {
                if ((m >> t) & 1u) {
                    sum[t] += v;
                    cnt[t] += 1;
                    jsum[t] += w;
                }
            }
        }
    }

    // One row read on its own (a shard's head and tail, unaligned columns).
    __device__ __forceinline__ void row(int fc, int ac, unsigned fv, int jc,
                                        unsigned jv,
                                        const int* __restrict__ ad,
                                        const int* __restrict__ rc) {
        const unsigned m = hits(fc, fv);
        int v = 0, w = 0;
        if (m) v = __ldg(ad + ac);
        if (m && jv) w = __ldg(rc + jc);
        add(m, v, w);
    }

    // Four rows: the masks first, then every gather the masks call for,
    // back to back and predicated, then the adds.
    __device__ __forceinline__ void group(const JoinGroup& g,
                                          const int* __restrict__ ad,
                                          const int* __restrict__ rc) {
        const unsigned m0 = hits(g.f.x, g.v.x), m1 = hits(g.f.y, g.v.y),
                       m2 = hits(g.f.z, g.v.z), m3 = hits(g.f.w, g.v.w);
        int v0 = 0, v1 = 0, v2 = 0, v3 = 0, w0 = 0, w1 = 0, w2 = 0, w3 = 0;
        if (m0) v0 = __ldg(ad + g.a.x);
        if (m1) v1 = __ldg(ad + g.a.y);
        if (m2) v2 = __ldg(ad + g.a.z);
        if (m3) v3 = __ldg(ad + g.a.w);
        if (m0 && g.w.x) w0 = __ldg(rc + g.j.x);
        if (m1 && g.w.y) w1 = __ldg(rc + g.j.y);
        if (m2 && g.w.z) w2 = __ldg(rc + g.j.z);
        if (m3 && g.w.w) w3 = __ldg(rc + g.j.w);
        add(m0, v0, w0);
        add(m1, v1, w1);
        add(m2, v2, w2);
        add(m3, v3, w3);
    }

    __device__ __forceinline__ void reduce(unsigned long long* red) const {
#pragma unroll
        for (int t = 0; t < QN; ++t) {
            add_warp(&red[t], sum[t]);
            add_warp(&red[QN + t], (long long)cnt[t]);
            add_warp(&red[2 * QN + t], jsum[t]);
        }
    }
};

// group g of the 16-byte-aligned columns, read once (evict-first)
__device__ __forceinline__ JoinGroup load_group(
        const int4* __restrict__ f4, const int4* __restrict__ a4,
        const int4* __restrict__ j4, const uchar4* __restrict__ v4,
        const uchar4* __restrict__ w4, long long g) {
    JoinGroup r;
    r.f = __ldcs(f4 + g);
    r.a = __ldcs(a4 + g);
    r.j = __ldcs(j4 + g);
    r.v = __ldcs(v4 + g);
    r.w = __ldcs(w4 + g);
    return r;
}

// The join lane's share of this block of one column's rows, as `scan_rows`
// (head, 16-byte groups, ragged tail; or a row at a time without VEC), with
// the next group's loads in flight while the current group gathers.
template <int QN, bool VEC>
__device__ __forceinline__ void join_rows(JoinAcc<QN>& acc,
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
            acc.row(fcodes[tid], acodes[tid], fvalid[tid], jcodes[tid],
                    jvalid[tid], ad, rc);
        const long long n4 = (n - head) >> 2;
        const int4* f4 = reinterpret_cast<const int4*>(fcodes + head);
        const int4* a4 = reinterpret_cast<const int4*>(acodes + head);
        const int4* j4 = reinterpret_cast<const int4*>(jcodes + head);
        const uchar4* v4 = reinterpret_cast<const uchar4*>(fvalid + head);
        const uchar4* w4 = reinterpret_cast<const uchar4*>(jvalid + head);
        long long g = tid;
        JoinGroup cur{}, nxt{};
        if (g < n4) cur = load_group(f4, a4, j4, v4, w4, g);
        while (g < n4) {
            const long long gn = g + nthreads;
            if (gn < n4) nxt = load_group(f4, a4, j4, v4, w4, gn);
            acc.group(cur, ad, rc);
            cur = nxt;
            g = gn;
        }
        // ragged tail (fewer than 4 rows), masked here rather than padded
        const long long i = head + (n4 << 2) + tid;
        if (i < n)
            acc.row(fcodes[i], acodes[i], fvalid[i], jcodes[i], jvalid[i],
                    ad, rc);
    } else {
        for (long long i = tid; i < n; i += nthreads)
            acc.row(fcodes[i], acodes[i], fvalid[i], jcodes[i], jvalid[i],
                    ad, rc);
    }
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

// The block's partials (red, after a __syncthreads) added into a (lanes, nq)
// output: one 64-bit atomicAdd per (lane, predicate).
template <int LANES, int QN>
__device__ __forceinline__ void add_block(const unsigned long long* red,
                                          unsigned long long* out, int nq,
                                          int q0) {
    if (threadIdx.x < LANES * QN) {
        const int which = threadIdx.x / QN;
        const int t = threadIdx.x % QN;
        const unsigned long long v = red[which * QN + t];
        if (q0 + t < nq && v) atomicAdd(&out[which * nq + q0 + t], v);
    }
}

// Blocks a multiprocessor must hold (__launch_bounds__): two (at most 64
// registers a thread) for the scan alone and for the join lane's
// one-predicate pass; the join lane's wide pass (QT predicates) needs more
// registers and keeps one. With CORR the grid has one more z slice than shards: the correction
// lane's (see the header). QN is QT without the join lane.
template <bool JOIN, bool VEC, bool CORR, int QN>
__global__ void __launch_bounds__(THREADS, (JOIN && QN > 1) ? 1 : 2)
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
    __shared__ unsigned long long red[3 * QN];
    constexpr int lanes = JOIN ? 3 : 2;
    const bool corr_slice = CORR && blockIdx.z == gridDim.z - 1;
    // blocks of the correction slice beyond the stacks' rows have nothing
    // to add (the whole block leaves together)
    if (corr_slice && (long long)blockIdx.x * blockDim.x >= nr_a &&
        (long long)blockIdx.x * blockDim.x >= nr_j)
        return;
    if (threadIdx.x < 3 * QN) red[threadIdx.x] = 0ull;
    __syncthreads();
    const int q0 = blockIdx.y * QN;

    if (corr_slice) {
        corr_pass<QN>(corr_a, nr_a, corr_base != 0, vbounds, nq, q0, red, 0,
                      1);
        if (JOIN)   // join weights: only the sum delta, into the join sum
            corr_pass<QN>(corr_j, nr_j, true, vbounds, nq, q0, red, 2, -1);
    } else {
        // this block's shard: n rows at a stride of n
        const long long base = (long long)blockIdx.z * n;
        // rows of this shard before its first 16-byte boundary (the host
        // chose VEC only where every column has its rows at one position
        // modulo 4)
        long long head = VEC ? (long long)((4 - row_mod4(fcodes + base)) & 3)
                             : 0;
        if (head > n) head = n;
        if constexpr (JOIN) {
            JoinAcc<QN> acc;
            acc.init(bounds, nq, q0);
            join_rows<QN, VEC>(acc, fcodes + base, acodes + base,
                               fvalid + base, jcodes + base, jvalid + base,
                               n, head, adict, rcount);
            acc.reduce(red);
        } else {
            Acc<> acc;
            init_acc(acc, bounds, nq, q0);
            scan_rows<VEC>(acc, fcodes + base, acodes + base, fvalid + base,
                           n, head, adict);
            reduce_acc(acc, red);
        }
    }
    __syncthreads();
    // slice z's partials start at z * lanes * nq
    add_block<lanes, QN>(red, out + (long long)blockIdx.z * lanes * nq, nq,
                         q0);
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

// The correction slice of a mesh launch (one z slice after the islands'):
// the stacks as `scan_exact_kernel` takes them and their Q inclusive value
// bounds, up to MAX_CORR_Q predicates (a larger group's launches take them
// MAX_CORR_Q at a time), all by value.
constexpr int MAX_CORR_Q = 64;

struct CorrSlice {
    const int* a;                 // aggregate stack, (6 or 3, nr_a)
    const int* j;                 // join-weight stack, (6, nr_j)
    long long nr_a;
    long long nr_j;
    int base;                     // 0: `a` holds only the effective triple
    int vb[2 * MAX_CORR_Q];       // (lo, hi) per predicate, inclusive
};

struct IslandCorrTable {          // the island table and the slice
    Island at[MAX_ISLANDS];
    CorrSlice corr;
};

template <bool CORR>
struct TableOf {
    using type = IslandTable;
};
template <>
struct TableOf<true> {
    using type = IslandCorrTable;
};

// A block of the correction slice: both stacks' deltas, QN predicates from
// the block's grid slice, into the launch's one (lanes, nq) output.
template <bool JOIN, int QN>
__device__ __forceinline__ void corr_block(const CorrSlice& c, int nq,
                                           unsigned long long* red,
                                           unsigned long long* out) {
    const long long first = (long long)blockIdx.x * blockDim.x;
    if (first >= c.nr_a && first >= c.nr_j) return;
    if (threadIdx.x < 3 * QN) red[threadIdx.x] = 0ull;
    __syncthreads();
    const int q0 = blockIdx.y * QN;
    corr_pass<QN>(c.a, c.nr_a, c.base != 0, c.vb, nq, q0, red, 0, 1);
    if (JOIN)   // join weights: only the sum delta, into the join sum
        corr_pass<QN>(c.j, c.nr_j, true, c.vb, nq, q0, red, 2, -1);
    __syncthreads();
    add_block<JOIN ? 3 : 2, QN>(red, out, nq, q0);
}

// With CORR the grid has one more z slice than islands, the correction's,
// as its FIRST slice: its few blocks start with the islands' instead of
// after them; without it the kernel is the plain island scan.
template <bool JOIN, bool CORR, int QN>
__global__ void __launch_bounds__(THREADS, (JOIN && QN > 1) ? 1 : 2)
scan_islands_kernel(const __grid_constant__ typename TableOf<CORR>::type tab,
                    const int* __restrict__ bounds, int nq,
                    unsigned long long* __restrict__ out) {
    __shared__ unsigned long long red[3 * QN];
    if constexpr (CORR) {
        if (blockIdx.z == 0) {
            corr_block<JOIN, QN>(tab.corr, nq, red, out);
            return;
        }
    }
    const Island& isl = tab.at[CORR ? blockIdx.z - 1 : blockIdx.z];
    // an island narrower than the widest has blocks with no rows of its
    // own (the whole block leaves together)
    if ((long long)blockIdx.x * blockDim.x >= isl.n) return;
    if (threadIdx.x < 3 * QN) red[threadIdx.x] = 0ull;
    __syncthreads();
    const int q0 = blockIdx.y * QN;
    if constexpr (JOIN) {
        JoinAcc<QN> acc;
        acc.init(bounds, nq, q0);
        const long long head = isl.head < isl.n ? isl.head : isl.n;
        if (isl.head >= 0)
            join_rows<QN, true>(acc, isl.fcodes, isl.acodes, isl.fvalid,
                                isl.jcodes, isl.jvalid, isl.n, head,
                                isl.adict, isl.rcount);
        else
            join_rows<QN, false>(acc, isl.fcodes, isl.acodes, isl.fvalid,
                                 isl.jcodes, isl.jvalid, isl.n, 0, isl.adict,
                                 isl.rcount);
        acc.reduce(red);
    } else {
        Acc<QN> acc;
        init_acc(acc, bounds, nq, q0);
        const long long head = isl.head < isl.n ? isl.head : isl.n;
        if (isl.head >= 0)
            scan_rows<true>(acc, isl.fcodes, isl.acodes, isl.fvalid, isl.n,
                            head, isl.adict);
        else
            scan_rows<false>(acc, isl.fcodes, isl.acodes, isl.fvalid, isl.n,
                             0, isl.adict);
        reduce_acc(acc, red);
    }
    __syncthreads();
    // every island of the launch adds into the one output
    add_block<JOIN ? 3 : 2, QN>(red, out, nq, q0);
}

// ---------------------------------------------------------------------------
// The correction lane alone
// ---------------------------------------------------------------------------

constexpr int VTHREADS = 256;     // a block: 256 stack rows a pass
constexpr int VMAX_BLOCKS = 1024; // more rows take more passes a thread

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Per predicate (QN of them from this block's grid slice), the effective
// rows' sum and count minus the base rows' over a (3 or 6, nr) stack, added
// into out (2, nq): sums, then counts. Only the predicates the group has
// are reduced.
template <int QN>
__global__ void __launch_bounds__(VTHREADS)
values_kernel(const int* __restrict__ stack, long long nr, int has_base,
              const int* __restrict__ vbounds, int nq,
              unsigned long long* __restrict__ out) {
    __shared__ unsigned long long red_sum[QN];
    __shared__ int red_cnt[QN];
    const int q0 = blockIdx.y * QN;
    const int live = nq - q0 < QN ? nq - q0 : QN;
    if (threadIdx.x < QN) {
        red_sum[threadIdx.x] = 0ull;
        red_cnt[threadIdx.x] = 0;
    }
    long long sum[QN];
    int cnt[QN], lo[QN], hi[QN];
#pragma unroll
    for (int t = 0; t < QN; ++t) {
        lo[t] = t < live ? vbounds[2 * (q0 + t)] : 1;       // 1 > 0: empty
        hi[t] = t < live ? vbounds[2 * (q0 + t) + 1] : 0;
        sum[t] = 0;
        cnt[t] = 0;
    }
    const long long step = (long long)gridDim.x * VTHREADS;
    for (long long i = (long long)blockIdx.x * VTHREADS + threadIdx.x;
         i < nr; i += step) {
        const int fe = __ldg(stack + i), ae = __ldg(stack + nr + i),
                  ve = __ldg(stack + 2 * nr + i);
        int fb = 0, ab = 0, vb = 0;
        if (has_base) {
            fb = __ldg(stack + 3 * nr + i);
            ab = __ldg(stack + 4 * nr + i);
            vb = __ldg(stack + 5 * nr + i);
        }
#pragma unroll
        for (int t = 0; t < QN; ++t) {
            const bool e = ve != 0 && fe >= lo[t] && fe <= hi[t];
            const bool b = vb != 0 && fb >= lo[t] && fb <= hi[t];
            sum[t] += (e ? (long long)ae : 0ll) - (b ? (long long)ab : 0ll);
            cnt[t] += (int)e - (int)b;
        }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < QN; ++t) {
        if (t < live) {               // the same for every thread
            const long long s = warp_sum(sum[t]);
            const int c = warp_sum_int(cnt[t]);
            if ((threadIdx.x & 31) == 0) {
                if (s) atomicAdd(&red_sum[t], (unsigned long long)s);
                if (c) atomicAdd(&red_cnt[t], c);
            }
        }
    }
    __syncthreads();
    if ((int)threadIdx.x < live) {
        const unsigned long long s = red_sum[threadIdx.x];
        const int c = red_cnt[threadIdx.x];
        if (s) atomicAdd(&out[q0 + threadIdx.x], s);
        if (c)
            atomicAdd(&out[nq + q0 + threadIdx.x],
                      (unsigned long long)(long long)c);
    }
}

inline bool aligned(const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

// Whether a column set can be read 16 bytes at a time from some row on:
// every int32 column at one row position modulo 4 and each validity byte
// column at the same position (an island, a shard or a view of a column at
// any offset qualifies; columns at different offsets do not).
inline bool same_phase(const int* f, const int* a, const uint8_t* v,
                       const int* j, const uint8_t* w) {
    const uintptr_t m = row_mod4(f);
    bool same = aligned(f, 4) && aligned(a, 4) && row_mod4(a) == m &&
                (reinterpret_cast<uintptr_t>(v) & 3) == m;
    if (j)
        same = same && aligned(j, 4) && row_mod4(j) == m &&
               (reinterpret_cast<uintptr_t>(w) & 3) == m;
    return same;
}

// Predicates a pass of the join lane: one for a one-predicate group, else
// the wide pass.
inline int join_qn(int nq) { return nq == 1 ? 1 : QT; }

template <bool JOIN, bool VEC, bool CORR, int QN>
cudaError_t launch(const int* fcodes, const int* acodes, const uint8_t* fvalid,
                   const int* adict, const int* bounds, int nq,
                   const int* jcodes, const uint8_t* jvalid, const int* rcount,
                   int n_shards, long long width, const int* corr_a,
                   long long nr_a, int corr_base, const int* corr_j,
                   long long nr_j, const int* vbounds,
                   unsigned long long* out, cudaStream_t stream) {
    auto kern = scan_exact_kernel<JOIN, VEC, CORR, QN>;
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
    long long want = (width + per_block - 1) / per_block;
    if (CORR) {
        const long long nr = nr_a > nr_j ? nr_a : nr_j;
        const long long cw = (nr + THREADS - 1) / THREADS;
        if (cw > want) want = cw;
    }
    long long cap = (long long)sms * occ / n_shards;
    if (cap < 1) cap = 1;
    if (want > cap) want = cap;
    if (want < 1) want = 1;
    dim3 grid((unsigned)want, (unsigned)((nq + QN - 1) / QN),
              (unsigned)(n_shards + (CORR ? 1 : 0)));
    kern<<<grid, THREADS, 0, stream>>>(fcodes, acodes, fvalid, adict, bounds,
                                       nq, jcodes, jvalid, rcount, width,
                                       corr_a, nr_a, corr_base, corr_j, nr_j,
                                       vbounds, out);
    return cudaGetLastError();
}

// The island kernel's grid: as many blocks as the card holds at once,
// shared among the islands, each island's share sized for the widest; with
// the correction slice at least a block a 512 stack rows (a launch may hold
// the slice alone: n_islands 0).
template <bool JOIN, bool CORR, int QN>
cudaError_t launch_islands(const typename TableOf<CORR>::type& tab,
                           int n_islands, long long widest, long long nr,
                           const int* bounds, int nq, unsigned long long* out,
                           cudaStream_t stream) {
    auto kern = scan_islands_kernel<JOIN, CORR, QN>;
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
    if (CORR && (nr + THREADS - 1) / THREADS > want)
        want = (nr + THREADS - 1) / THREADS;
    long long cap = (long long)sms * occ / (n_islands > 0 ? n_islands : 1);
    if (cap < 1) cap = 1;
    if (want > cap) want = cap;
    if (want < 1) want = 1;
    dim3 grid((unsigned)want, (unsigned)((nq + QN - 1) / QN),
              (unsigned)(n_islands + (CORR ? 1 : 0)));
    kern<<<grid, THREADS, 0, stream>>>(tab, bounds, nq, out);
    return cudaGetLastError();
}

// Fills the island table from the host's ISLAND_FIELDS int64s an island;
// returns the widest island's rows, or -1 for a malformed island.
constexpr int ISLAND_FIELDS = 8;

long long fill_islands(Island* at, const long long* table, int n_islands,
                       bool join) {
    long long widest = 0;
    for (int s = 0; s < n_islands; ++s) {
        const long long* f = table + s * ISLAND_FIELDS;
        Island& isl = at[s];
        isl.fcodes = reinterpret_cast<const int*>(f[0]);
        isl.acodes = reinterpret_cast<const int*>(f[1]);
        isl.fvalid = reinterpret_cast<const uint8_t*>(f[2]);
        isl.adict = reinterpret_cast<const int*>(f[3]);
        isl.jcodes = join ? reinterpret_cast<const int*>(f[4]) : nullptr;
        isl.jvalid = join ? reinterpret_cast<const uint8_t*>(f[5]) : nullptr;
        isl.rcount = join ? reinterpret_cast<const int*>(f[6]) : nullptr;
        isl.n = f[7];
        if (isl.n <= 0 || (join && (!isl.jcodes || !isl.jvalid))) return -1;
        if (isl.n > widest) widest = isl.n;
        // 16-byte loads from the first row at which every column is
        // aligned, where that is one row for all of them: an island is a
        // slice of a column at any offset, so only its rows' position
        // modulo 4 tells
        isl.head = same_phase(isl.fcodes, isl.acodes, isl.fvalid, isl.jcodes,
                              isl.jvalid)
                       ? (int)((4 - row_mod4(isl.fcodes)) & 3)
                       : -1;
    }
    return widest;
}

// Predicates a pass of the island kernel: the join lane's rule (one for a
// one-predicate group), and the same for the scan's instance with the
// correction slice; the scan's without it keeps QT.
template <bool JOIN, bool CORR>
cudaError_t islands_by_qn(const typename TableOf<CORR>::type& tab,
                          int n_islands, long long widest, long long nr,
                          const int* bounds, int nq, unsigned long long* out,
                          cudaStream_t st) {
    if constexpr (JOIN || CORR) {
        if (join_qn(nq) == 1)
            return launch_islands<JOIN, CORR, 1>(tab, n_islands, widest, nr,
                                                 bounds, nq, out, st);
    }
    return launch_islands<JOIN, CORR, QT>(tab, n_islands, widest, nr, bounds,
                                          nq, out, st);
}

}  // namespace

// Columns are (n_shards, width) row-major, n_shards >= 1; out: (n_shards,
// 2, nq) int64 zeros without the join lane (sums, counts), (n_shards, 3,
// nq) with it (sums, counts, join sums). jcodes == nullptr selects no join
// lane. vbounds != nullptr adds the correction lane and one output row
// after the shards' (out: (n_shards + 1, lanes, nq)): corr_a is the
// aggregate stack, (6, nr_a) int32, or (3, nr_a) with only the effective
// triple when corr_base is 0; corr_j the join-weight stack, (6, nr_j), with
// the join lane only; vbounds (nq, 2) inclusive raw-value ranges. The lane
// alone is `scan_values`.
extern "C" int scan_exact(const int* fcodes, const int* acodes,
                          const uint8_t* fvalid, const int* adict,
                          const int* bounds, int nq, const int* jcodes,
                          const uint8_t* jvalid, const int* rcount,
                          int n_shards, long long width, const int* corr_a,
                          long long nr_a, int corr_base, const int* corr_j,
                          long long nr_j, const int* vbounds,
                          unsigned long long* out, void* stream) {
    const bool corr = vbounds != nullptr;
    if (nq <= 0) return (int)cudaSuccess;
    if (n_shards < 1 || width < 0 || nr_a < 0 || nr_j < 0)
        return (int)cudaErrorInvalidValue;
    if (!corr && width == 0) return (int)cudaSuccess;
    if (n_shards + (corr ? 1 : 0) > 65535 || (nq + QT - 1) / QT > 65535)
        return (int)cudaErrorInvalidValue;
    const bool join = jcodes != nullptr;
    // 16-byte loads where every column has its rows at one position modulo
    // 4; each shard steps up to its own first aligned row in the kernel
    const bool vec = same_phase(fcodes, acodes, fvalid, jcodes, jvalid);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GO(J, V, C, Q)                                                      \
    launch<J, V, C, Q>(fcodes, acodes, fvalid, adict, bounds, nq, jcodes,   \
                       jvalid, rcount, n_shards, width, corr_a, nr_a,       \
                       corr_base, corr_j, nr_j, vbounds, out, s)
#define BY_VEC_CORR(J, Q)                                                   \
    (corr ? (vec ? GO(J, true, true, Q) : GO(J, false, true, Q))            \
          : (vec ? GO(J, true, false, Q) : GO(J, false, false, Q)))
    cudaError_t err;
    if (!join)
        err = BY_VEC_CORR(false, QT);
    else if (join_qn(nq) == 1)
        err = BY_VEC_CORR(true, 1);
    else
        err = BY_VEC_CORR(true, QT);
#undef BY_VEC_CORR
#undef GO
    return (int)err;
}

// The mesh scans' launch: `table` is HOST memory, ISLAND_FIELDS int64s per
// island - fcodes, acodes, fvalid, adict, jcodes, jvalid, rcount (device
// pointers; the last three 0 without the join lane) and the island's rows
// n - for 0 <= n_islands <= MAX_ISLANDS non-empty flat islands on the
// current device. Every island's (sums, counts[, join sums]) for the
// (nq, 2) code ranges `bounds` are added into the one zeroed (2|3, nq)
// int64 `out`. `vbounds` (HOST memory, (nq, 2) inclusive value ranges, nq
// <= MAX_CORR_Q) adds the correction slice over the device stacks corr_a
// and, with the join lane, corr_j, as `scan_exact` takes them, into the
// same `out`; without it n_islands 0 launches nothing.
extern "C" int scan_exact_islands(const long long* table, int n_islands,
                                  const int* bounds, int nq, int join,
                                  const int* corr_a, long long nr_a,
                                  int corr_base, const int* corr_j,
                                  long long nr_j, const int* vbounds,
                                  unsigned long long* out, void* stream) {
    const bool corr = vbounds != nullptr;
    if (nq <= 0 || (n_islands == 0 && !corr)) return (int)cudaSuccess;
    if (n_islands < 0 || n_islands > MAX_ISLANDS ||
        (nq + QT - 1) / QT > 65535 || nr_a < 0 || nr_j < 0 ||
        (corr && nq > MAX_CORR_Q))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (!corr) {
        IslandTable tab = {};
        const long long widest = fill_islands(tab.at, table, n_islands, join);
        if (widest < 0) return (int)cudaErrorInvalidValue;
        err = join ? islands_by_qn<true, false>(tab, n_islands, widest, 0,
                                                bounds, nq, out, st)
                   : islands_by_qn<false, false>(tab, n_islands, widest, 0,
                                                 bounds, nq, out, st);
        return (int)err;
    }
    IslandCorrTable tab = {};
    const long long widest = fill_islands(tab.at, table, n_islands, join);
    if (widest < 0) return (int)cudaErrorInvalidValue;
    CorrSlice& c = tab.corr;
    c.a = corr_a;
    c.nr_a = corr_a ? nr_a : 0;
    c.base = corr_base;
    c.j = join ? corr_j : nullptr;
    c.nr_j = join && corr_j ? nr_j : 0;
    for (int i = 0; i < 2 * nq; ++i) c.vb[i] = vbounds[i];
    const long long nr = c.nr_a > c.nr_j ? c.nr_a : c.nr_j;
    err = join ? islands_by_qn<true, true>(tab, n_islands, widest, nr, bounds,
                                           nq, out, st)
               : islands_by_qn<false, true>(tab, n_islands, widest, nr,
                                            bounds, nq, out, st);
    return (int)err;
}

// The correction lane alone over a (6, nr) stack (3 rows when corr_base is
// 0) on the current device: per (nq, 2) inclusive range `vbounds` (device)
// the effective-minus-base sum and count added into the zeroed (2, nq)
// int64 `out`.
extern "C" int scan_values(const int* stack, long long nr, int corr_base,
                           const int* vbounds, int nq,
                           unsigned long long* out, void* stream) {
    if (nq <= 0 || nr == 0) return (int)cudaSuccess;
    if (nr < 0) return (int)cudaErrorInvalidValue;
    const int qn = nq == 1 ? 1 : QT;
    if ((nq + qn - 1) / qn > 65535) return (int)cudaErrorInvalidValue;
    long long blocks = (nr + VTHREADS - 1) / VTHREADS;
    if (blocks > VMAX_BLOCKS) blocks = VMAX_BLOCKS;
    dim3 grid((unsigned)blocks, (unsigned)((nq + qn - 1) / qn));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (qn == 1)
        values_kernel<1><<<grid, VTHREADS, 0, st>>>(stack, nr, corr_base,
                                                    vbounds, nq, out);
    else
        values_kernel<QT><<<grid, VTHREADS, 0, st>>>(stack, nr, corr_base,
                                                     vbounds, nq, out);
    return (int)cudaGetLastError();
}

// Blocks of THREADS threads one multiprocessor holds at once, by the
// occupancy API, of the scan kernel instance (join, vec, corr, qn) - qn 1
// or QT (8) with the join lane, QT without - into *blocks.
extern "C" int scan_exact_occupancy(int join, int vec, int corr, int qn,
                                    int* blocks) {
    if (qn != 1 && qn != QT) return (int)cudaErrorInvalidValue;
    if (!join && qn != QT) return (int)cudaErrorInvalidValue;
#define OCC(J, V, C, Q)                                                     \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                          \
        blocks, scan_exact_kernel<J, V, C, Q>, THREADS, 0)
#define BY(J, Q)                                                            \
    (corr ? (vec ? OCC(J, true, true, Q) : OCC(J, false, true, Q))          \
          : (vec ? OCC(J, true, false, Q) : OCC(J, false, false, Q)))
    cudaError_t err;
    if (!join)
        err = BY(false, QT);
    else if (qn == 1)
        err = BY(true, 1);
    else
        err = BY(true, QT);
#undef BY
#undef OCC
    return (int)err;
}

// The same for the island kernel's instance (join, corr, qn) - qn 1 or
// QT with the join lane or the correction slice, QT otherwise.
extern "C" int scan_islands_occupancy(int join, int corr, int qn,
                                      int* blocks) {
    if (qn != 1 && qn != QT) return (int)cudaErrorInvalidValue;
    if (!join && !corr && qn != QT) return (int)cudaErrorInvalidValue;
#define OCC(J, C, Q)                                                        \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                          \
        blocks, scan_islands_kernel<J, C, Q>, THREADS, 0)
    cudaError_t err;
    if (!join && qn == 1)
        err = OCC(false, true, 1);
    else if (!join)
        err = corr ? OCC(false, true, QT) : OCC(false, false, QT);
    else if (qn == 1)
        err = corr ? OCC(true, true, 1) : OCC(true, false, 1);
    else
        err = corr ? OCC(true, true, QT) : OCC(true, false, QT);
#undef OCC
    return (int)err;
}

// The text of a CUDA error code, for the Python side's exceptions.
extern "C" const char* cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
