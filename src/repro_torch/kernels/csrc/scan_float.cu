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
// per row; the dictionary is gathered through L1 and L2, only for rows that
// pass the mask. To read at the card's rate an SM needs some 15 - 20 KB in
// flight (Little's law: 3.35 TB/s x about 0.6 us over 132 SMs). So:
//   - every column is read 16 bytes a thread (fcodes and acodes as int4,
//     valid as uchar4: 4 rows, 36 bytes), unconditionally and evict-first,
//     two such groups a loop step, both issued before either group's
//     compares; a view whose first row is not on a 16-byte boundary reads
//     its first rows one at a time up to it (as `scan_exact.cu`), and
//     columns at different positions modulo 4 read each group's rows one
//     at a time, in the same order;
//   - the gathers are predicated on the rows' masks and issued back to
//     back, the eight of a step before any add;
//   - the block is 256 threads and eight may share an SM (2,048 threads,
//     `__launch_bounds__`), so an SM has up to 2,048 x 72 bytes asked for;
//   - a call is ONE launch: each block writes its partial sum and count,
//     then takes a ticket (a fence and an atomicAdd on a counter); the
//     block that draws the last ticket adds every block's partial in index
//     order and writes the result, then sets the counter back to 0 for the
//     next launch. No atomics touch the sums, so the sum is the same from
//     run to run.
//
// The summation order, which `float_scan_error_bound` (kernels/dict_ops/
// ops.py) bounds and `tests/test_torch_kernels_scan_float.py` models: each
// row's int32 value is converted to float32; a group of four rows is summed
// as (r0 + r1) + (r2 + r3); a thread adds into its sum s, in order, its head
// row (if any), its groups g = tid, tid + T, tid + 2T, ... (T the grid's
// threads) and its tail row (if any); the block adds its threads' sums by
// warp-shuffle trees (5 levels, then 3 over the 8 warps' sums); the last
// block's thread i adds partials i, i + 256, ... in order, and its block
// tree adds those. It is another order than the TPU's sequential one, so
// the float32 sums differ in their last bits (the count is exact). The
// reference pads the rows to its block with fcodes = int32.max and valid =
// 0, which match no predicate; here the grid stops at n instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 8;         // blocks an SM holds at once

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

// Four consecutive rows.
struct Rows4 {
    int4 f, a;
    uchar4 v;
};

// Group g: 16 bytes a column (VEC: the columns from the group's first row
// are 16-byte aligned), else the four rows one at a time.
template <bool VEC>
__device__ __forceinline__ Rows4 load4(const int* __restrict__ fcodes,
                                       const int* __restrict__ acodes,
                                       const uint8_t* __restrict__ valid,
                                       long long g) {
    Rows4 r;
    if (VEC) {
        r.f = __ldcs(reinterpret_cast<const int4*>(fcodes) + g);
        r.a = __ldcs(reinterpret_cast<const int4*>(acodes) + g);
        r.v = __ldcs(reinterpret_cast<const uchar4*>(valid) + g);
    } else {
        const long long i = g << 2;
        r.f = make_int4(fcodes[i], fcodes[i + 1], fcodes[i + 2],
                        fcodes[i + 3]);
        r.a = make_int4(acodes[i], acodes[i + 1], acodes[i + 2],
                        acodes[i + 3]);
        r.v = make_uchar4(valid[i], valid[i + 1], valid[i + 2], valid[i + 3]);
    }
    return r;
}

struct Pred {
    int lo, hi;
    __device__ __forceinline__ bool hit(int f, unsigned v) const {
        return v && f >= lo && f < hi;
    }
};

// Groups A and B (B empty when !two): the masks, then the gathers back to
// back, then each group's (r0 + r1) + (r2 + r3) added to s, A first.
__device__ __forceinline__ void add_groups(float& s, int& c, const Pred& p,
                                           const Rows4& A, const Rows4& B,
                                           bool two,
                                           const int* __restrict__ dict) {
    const bool a0 = p.hit(A.f.x, A.v.x), a1 = p.hit(A.f.y, A.v.y),
               a2 = p.hit(A.f.z, A.v.z), a3 = p.hit(A.f.w, A.v.w);
    const bool b0 = two && p.hit(B.f.x, B.v.x), b1 = two && p.hit(B.f.y, B.v.y),
               b2 = two && p.hit(B.f.z, B.v.z), b3 = two && p.hit(B.f.w, B.v.w);
    int x0 = 0, x1 = 0, x2 = 0, x3 = 0, y0 = 0, y1 = 0, y2 = 0, y3 = 0;
    if (a0) x0 = __ldg(dict + A.a.x);
    if (a1) x1 = __ldg(dict + A.a.y);
    if (a2) x2 = __ldg(dict + A.a.z);
    if (a3) x3 = __ldg(dict + A.a.w);
    if (b0) y0 = __ldg(dict + B.a.x);
    if (b1) y1 = __ldg(dict + B.a.y);
    if (b2) y2 = __ldg(dict + B.a.z);
    if (b3) y3 = __ldg(dict + B.a.w);
    s += ((float)x0 + (float)x1) + ((float)x2 + (float)x3);
    if (two) s += ((float)y0 + (float)y1) + ((float)y2 + (float)y3);
    c += (int)a0 + (int)a1 + (int)a2 + (int)a3 + (int)b0 + (int)b1 +
         (int)b2 + (int)b3;
}

// `head` rows before the first 16-byte boundary (0 without VEC); the grid's
// `stride` threads take groups g = tid, tid + stride, ... of the rows after
// the head.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
scan_float_kernel(const int* __restrict__ fcodes,
                  const int* __restrict__ acodes,
                  const uint8_t* __restrict__ valid,
                  const int* __restrict__ dict, long long n, long long head,
                  int lo, int hi, float* __restrict__ psum,
                  int* __restrict__ pcnt, unsigned* __restrict__ counter,
                  float* __restrict__ out_sum, int* __restrict__ out_cnt) {
    __shared__ float ssum[THREADS / 32];
    __shared__ int scnt[THREADS / 32];
    __shared__ bool last;
    const Pred p{lo, hi};
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long stride = (long long)gridDim.x * THREADS;
    float s = 0.f;
    int c = 0;
    if (tid < head && p.hit(fcodes[tid], valid[tid])) {
        s += (float)__ldg(dict + acodes[tid]);
        c += 1;
    }
    const long long n4 = (n - head) >> 2;
    const int* f = fcodes + head;
    const int* a = acodes + head;
    const uint8_t* v = valid + head;
    long long g = tid;
    for (; g + stride < n4; g += 2 * stride) {
        const Rows4 A = load4<VEC>(f, a, v, g);
        const Rows4 B = load4<VEC>(f, a, v, g + stride);
        add_groups(s, c, p, A, B, true, dict);
    }
    if (g < n4) {
        const Rows4 A = load4<VEC>(f, a, v, g);
        add_groups(s, c, p, A, A, false, dict);
    }
    // ragged tail (fewer than 4 rows)
    const long long i = head + (n4 << 2) + tid;
    if (i < n && p.hit(fcodes[i], valid[i])) {
        s += (float)__ldg(dict + acodes[i]);
        c += 1;
    }

    s = block_sum(s, ssum);
    c = block_sum(c, scnt);
    if (threadIdx.x == 0) {
        psum[blockIdx.x] = s;
        pcnt[blockIdx.x] = c;
        __threadfence();           // the partial is visible before the ticket
        last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    // the last block: every partial, in index order (read from L2)
    __threadfence();
    s = 0.f;
    c = 0;
    for (int k = threadIdx.x; k < (int)gridDim.x; k += THREADS) {
        s += __ldcg(psum + k);
        c += __ldcg(pcnt + k);
    }
    s = block_sum(s, ssum);
    c = block_sum(c, scnt);
    if (threadIdx.x == 0) {
        *out_sum = s;
        *out_cnt = c;
        *counter = 0u;             // left 0 for the next launch
    }
}

inline uintptr_t row_mod4(const int* p) {
    return (reinterpret_cast<uintptr_t>(p) >> 2) & 3;
}

// the columns' rows all at one position modulo 4 (16-byte loads from the
// first aligned row on)
inline bool same_phase(const int* f, const int* a, const uint8_t* v) {
    const uintptr_t m = row_mod4(f);
    return (reinterpret_cast<uintptr_t>(f) & 3) == 0 &&
           (reinterpret_cast<uintptr_t>(a) & 3) == 0 && row_mod4(a) == m &&
           (reinterpret_cast<uintptr_t>(v) & 3) == m;
}

}  // namespace

// fcodes, acodes (n,) int32; valid (n,) one byte a row; dict (k,) int32;
// psum / pcnt scratch of n_parts entries (the grid's blocks); counter one
// uint32 that is 0 and is left 0 (one per stream: launches in one stream's
// order may share it, launches running at once may not); out_sum (1,)
// float32 and out_cnt (1,) int32. One launch.
extern "C" int scan_float(const int* fcodes, const int* acodes,
                          const uint8_t* valid, const int* dict, long long n,
                          int lo, int hi, float* psum, int* pcnt, int n_parts,
                          unsigned* counter, float* out_sum, int* out_cnt,
                          void* stream) {
    if (n_parts < 1 || n < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (same_phase(fcodes, acodes, valid)) {
        long long head = (long long)((4 - row_mod4(fcodes)) & 3);
        if (head > n) head = n;
        scan_float_kernel<true><<<n_parts, THREADS, 0, s>>>(
            fcodes, acodes, valid, dict, n, head, lo, hi, psum, pcnt, counter,
            out_sum, out_cnt);
    } else {
        scan_float_kernel<false><<<n_parts, THREADS, 0, s>>>(
            fcodes, acodes, valid, dict, n, 0, lo, hi, psum, pcnt, counter,
            out_sum, out_cnt);
    }
    return (int)cudaGetLastError();
}

// Blocks of 256 threads one multiprocessor holds at once, by the occupancy
// API, of the 16-byte instance (vec != 0) or the row-at-a-time one.
extern "C" int scan_float_occupancy(int vec, int* blocks) {
    return (int)(vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, scan_float_kernel<true>, THREADS, 0)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           blocks, scan_float_kernel<false>, THREADS, 0));
}
