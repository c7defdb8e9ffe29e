// Row-wise sort (int32 or float32 keys), row-wise merge of sorted runs, and
// their fusion into the ship batch's dictionary pipeline (int32).
//
// Replaces the TPU kernels `_sort_kernel` / `bitonic_sort_rows` and
// `_merge_kernel` / `bitonic_merge_rows` (kernels/bitonic_sort/
// bitonic_sort.py of the JAX package) and their one-launch composition
// `_apply_pipeline_kernel_body` / `apply_pipeline_batch`
// (kernels/dict_ops/ops.py): per row (one column of a ship batch), sort the
// pending update values, then merge them with the column's old sorted
// dictionary into next_pow2(w_old + w_val) slots with int32.max tails.
//
// What bounds it on an H100: bytes (each row is read once and written
// once, 2 * width * 4 bytes). A ship batch has one row per touched column -
// a handful of rows of up to 65,536 output slots - so a design with one
// block a row leaves most of the card idle; this one cuts every row into
// output tiles:
//   * the merge is a grid over (output tiles of MT slots, rows). Each block
//     finds where its tile starts in both inputs by a merge-path search
//     (the cross-diagonal binary search; ties put the old key first), stages
//     the two input slices it needs in shared memory with 16-byte
//     asynchronous copies (`cp.async`: a thread's copies in flight at once),
//     lets each thread merge IPT consecutive slots of the tile from its own
//     merge-path split, and writes the tile with 16-byte stores. A tile past
//     the inputs' length is only filled with the padding key. Neighbouring
//     blocks compute the same split at their common boundary, so every slot
//     is written once. The same tile merge is the row-wise merge of sorted
//     runs (`bitonic_merge_rows`: the tiled sort's pairwise merges);
//   * the sort is a bitonic network over a tile held in shared memory
//     (one block per tile, up to 32768 values = 128 KB, which needs the
//     opt-in above 48 KB, granted once per device); a row wider than a tile
//     is sorted tile by tile and the tiles are merged pairwise by the tile
//     merge;
//   * the fused entry: up to SORT_IN_BLOCK (2,048) update values a row -
//     a ship batch's are a few hundred - every merge block sorts the row's
//     values in its own shared memory, beside the slice of the old
//     dictionary its tile can reach ([t0 - w_val, t0 + MT), copied while the
//     values are sorted, so its merge-path search runs in shared memory),
//     and the row's first block writes the sorted values. 2,048 keeps the
//     block's shared memory at 32 KB (no opt-in, several blocks an SM) and
//     its sort at 66 network stages; above it the redundant per-block sort
//     and the wider slice would cost more than one separate sort, so the
//     same C entry sorts the values first (`sort_tiles_kernel`, and the
//     pairwise merges above 32,768) and then runs the tile merge reading
//     them from device memory: one host call either way.
// The merged row equals a sort of the concatenation because a sorted row is
// determined by its multiset, sentinels included. The sort and the merge
// are templated on the key: int32 pads with int32.max, float32 with NaN,
// the largest key of its order (NaN sorts after +inf, as in torch.sort and
// jnp.sort), so a row's real keys always come first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int I32MAX = 0x7fffffff;
constexpr int MAX_TILE = 32768;       // values one block sorts in shared memory
constexpr int MT = 4096;              // output slots a merge block writes
constexpr int MT_THREADS = 256;
constexpr int IPT = MT / MT_THREADS;  // consecutive slots a thread merges
constexpr int SORT_IN_BLOCK = 2048;   // the fused entry's in-block sort
constexpr int MAX_DEVICES = 64;

// the padding key: the largest key of the order
template <typename T> __device__ __forceinline__ T pad_key();
template <> __device__ __forceinline__ int pad_key<int>() { return I32MAX; }
template <> __device__ __forceinline__ float pad_key<float>() {
    return __int_as_float(0x7fc00000);   // quiet NaN
}

__device__ __forceinline__ int key_bits(int x) { return x; }
__device__ __forceinline__ int key_bits(float x) { return __float_as_int(x); }

// Ascending bitonic sort of s[0..n), n a power of two, by the whole block.
// The caller synchronises after filling s; s is sorted and visible to all
// threads on return.
template <typename T>
__device__ void bitonic_sort_shared(T* s, int n) {
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
                // t-th comparator of this stage: insert a 0 bit at log2(j)
                const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
                const int p = i | j;
                const bool up = (i & k) == 0;
                const T x = s[i], y = s[p];
                if (key_lt(y, x) == up) {
                    s[i] = y;
                    s[p] = x;
                }
            }
            __syncthreads();
        }
    }
}

template <typename T>
__global__ void sort_tiles_kernel(const T* __restrict__ in,
                                  T* __restrict__ out, int width, int tile,
                                  int width_pad) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* s = reinterpret_cast<T*>(smem);
    const int t0 = blockIdx.x * tile;
    const int r = blockIdx.y;
    const T* row = in + (long long)r * width;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int g = t0 + i;
        s[i] = g < width ? row[g] : pad_key<T>();
    }
    __syncthreads();
    bitonic_sort_shared(s, tile);
    T* orow = out + (long long)r * width_pad + t0;
    for (int i = threadIdx.x; i < tile; i += blockDim.x) orow[i] = s[i];
}

// ---------------------------------------------------------------------------
// the tile merge
// ---------------------------------------------------------------------------

// The merge-path split of diagonal d: how many of the first d outputs of the
// merge of ascending a[0..wa) and b[0..wb) come from a, equal keys a first.
// Entry i of a is a[i - a_off] (a may be a staged window), the same for b.
template <typename T>
__device__ __forceinline__ int merge_path(const T* a, int a_off, int wa,
                                          const T* b, int b_off, int wb,
                                          int d) {
    int lo = d > wb ? d - wb : 0;
    int hi = d < wa ? d : wa;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_lt(b[d - 1 - mid - b_off], a[mid - a_off])) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

// The same split computed by a whole warp over device memory: each step
// probes 32 points of the range at once (a ballot of the monotone test
// "a[mid] goes before b[d - 1 - mid]"), so a range of 32,768 takes 3
// dependent loads instead of 16. Every lane returns the split.
template <typename T>
__device__ int merge_path_warp(const T* a, int wa, const T* b, int wb,
                               int d) {
    const int lane = threadIdx.x & 31;
    int lo = d > wb ? d - wb : 0;
    int hi = d < wa ? d : wa;
    while (lo < hi) {
        const int span = hi - lo;
        const int mid = lo + (int)(((long long)span * lane) >> 5);
        const bool before = !key_lt(b[d - 1 - mid], a[mid]);
        const unsigned m = __ballot_sync(0xffffffffu, before);
        const int t = __popc(m);              // the lanes before the split
        const int mid_last = lo + (int)(((long long)span * (t - 1)) >> 5);
        const int mid_next = lo + (int)(((long long)span * t) >> 5);
        if (t > 0) lo = mid_last + 1;
        if (t < 32) hi = mid_next;
    }
    return lo;
}

// Slots g .. g + IPT of the merge from split (i, j) into v, the padding key
// from slot `total` (= wa + wb) on. Indices as in merge_path.
template <typename T>
__device__ __forceinline__ void merge_run(const T* a, int a_off, int wa,
                                          const T* b, int b_off, int wb,
                                          int i, int j, int g, int total,
                                          T (&v)[IPT]) {
#pragma unroll
    for (int m = 0; m < IPT; ++m) {
        T x = pad_key<T>();
        if (g + m < total) {
            if (j >= wb || (i < wa && !key_lt(b[j - b_off], a[i - a_off]))) {
                x = a[i - a_off];
                ++i;
            } else {
                x = b[j - b_off];
                ++j;
            }
        }
        v[m] = x;
    }
}

// 16 bytes from device to shared memory without a register: every copy a
// thread issues is in flight at once, until the group is waited for.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight
// (a __syncthreads must follow before other threads read the data).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// s[0 ..) = x[lo .. hi) and more: asynchronous 16-byte copies of x[lo & ~3
// .. ceil4(hi)) where the row allows them (16-byte aligned, a width that is
// a multiple of 4; the caller commits and waits), one key a thread
// otherwise. Returns the index of x that s[0] holds. s has room for hi -
// lo + 6 keys. By the whole block.
template <typename T>
__device__ __forceinline__ int stage(T* s, const T* x, int width, int lo,
                                     int hi) {
    if (hi <= lo) return lo;
    if ((reinterpret_cast<uintptr_t>(x) & 15) == 0 && (width & 3) == 0) {
        const int lo4 = lo & ~3, n4 = (((hi + 3) & ~3) - lo4) >> 2;
        const int4* x4 = reinterpret_cast<const int4*>(x + lo4);
        int4* s4 = reinterpret_cast<int4*>(s);
        for (int q = threadIdx.x; q < n4; q += blockDim.x)
            cp_async16(s4 + q, x4 + q);
        return lo4;
    }
    for (int q = threadIdx.x; q < hi - lo; q += blockDim.x) s[q] = x[lo + q];
    return lo;
}

// out[0 .. n) = s[0 .. n), 16-byte stores where out is 16-byte aligned (s
// always is). By the whole block.
template <typename T>
__device__ __forceinline__ void store_tile(T* out, const T* s, int n) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        const int n4 = n >> 2;
        for (int q = threadIdx.x; q < n4; q += blockDim.x)
            reinterpret_cast<int4*>(out)[q] =
                reinterpret_cast<const int4*>(s)[q];
        done = n4 << 2;
    }
    for (int q = done + threadIdx.x; q < n; q += blockDim.x) out[q] = s[q];
}

// out[0 .. n) = the padding key, as store_tile stores.
template <typename T>
__device__ __forceinline__ void fill_pad(T* out, int n) {
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        const int p = key_bits(pad_key<T>());
        const int4 p4 = make_int4(p, p, p, p);
        const int n4 = n >> 2;
        for (int q = threadIdx.x; q < n4; q += blockDim.x)
            reinterpret_cast<int4*>(out)[q] = p4;
        done = n4 << 2;
    }
    for (int q = done + threadIdx.x; q < n; q += blockDim.x)
        out[q] = pad_key<T>();
}

// Each thread's IPT merged slots into s (16-byte shared stores), then the
// tile out of s. The caller has synchronised after the last read of s.
template <typename T>
__device__ __forceinline__ void write_tile(T* out, T* s, const T (&v)[IPT],
                                           int n) {
    int4* s4 = reinterpret_cast<int4*>(s + threadIdx.x * IPT);
#pragma unroll
    for (int q = 0; q < IPT / 4; ++q)
        s4[q] = make_int4(key_bits(v[4 * q]), key_bits(v[4 * q + 1]),
                          key_bits(v[4 * q + 2]), key_bits(v[4 * q + 3]));
    __syncthreads();
    store_tile(out, s, n);
}

// Row r's output tile [t0, t0 + MT) of the merge of a (wa keys a row) and
// b (wb) into out (w_out slots, the padding key from wa + wb on), both
// inputs in device memory: the block's splits by two warps, the two slices
// staged, then each thread's slots from its split within the slices.
template <typename T>
__global__ void __launch_bounds__(MT_THREADS)
merge_tiles_kernel(const T* __restrict__ a, long long a_stride, int wa,
                   const T* __restrict__ b, long long b_stride, int wb,
                   T* __restrict__ out, long long out_stride, int w_out,
                   int rows) {
    __shared__ __align__(16) T sa[MT + 8];
    __shared__ __align__(16) T sb[MT + 8];
    __shared__ int split[2];
    const int total = wa + wb;
    const int t0 = blockIdx.x * MT;
    const int n_tile = w_out - t0 < MT ? w_out - t0 : MT;
    for (int r = blockIdx.y; r < rows; r += gridDim.y) {
        T* orow = out + r * out_stride + t0;
        if (t0 >= total) {            // the whole block: padding only
            fill_pad(orow, n_tile);
            continue;
        }
        const T* ar = a + r * a_stride;
        const T* br = b + r * b_stride;
        const int d1 = t0 + MT < total ? t0 + MT : total;
        const int warp = threadIdx.x >> 5;
        if (warp < 2) {
            const int s = merge_path_warp(ar, wa, br, wb, warp ? d1 : t0);
            if ((threadIdx.x & 31) == 0) split[warp] = s;
        }
        __syncthreads();
        const int a_lo = split[0], a_hi = split[1];
        const int b_lo = t0 - a_lo, b_hi = d1 - a_hi;
        // slice-local indices: entry i of the tile's a slice is
        // sa[i - a_off], a_off = (staged start) - a_lo <= 0
        const int a_off = stage(sa, ar, wa, a_lo, a_hi) - a_lo;
        const int b_off = stage(sb, br, wb, b_lo, b_hi) - b_lo;
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        const int la = a_hi - a_lo, lb = b_hi - b_lo;
        const int g = threadIdx.x * IPT;
        T v[IPT];
        const int i = g < la + lb ? merge_path(sa, a_off, la, sb, b_off, lb, g)
                                  : la;
        merge_run(sa, a_off, la, sb, b_off, lb, i, g - i, g, la + lb, v);
        __syncthreads();
        write_tile(orow, sa, v, n_tile);
        __syncthreads();              // before the next row's staging
    }
}

// The fused pipeline's merge tile (w_val <= SORT_IN_BLOCK): the row's
// values sorted in this block's shared memory (sb), the old dictionary's
// slice that output tile [t0, t0 + MT) can reach, [t0 - w_val, t0 + MT),
// staged beside them (sa), each thread's split searched there.
__global__ void __launch_bounds__(MT_THREADS)
apply_tiles_kernel(const int* __restrict__ old, int w_old,
                   const int* __restrict__ vals, int w_val,
                   int* __restrict__ svals, int* __restrict__ merged,
                   int w_merge, int rows) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* sa = reinterpret_cast<int*>(smem);
    int* sb = sa + ((MT + w_val + 8 + 3) & ~3);
    const int wa = w_old, wb = w_val, total = wa + wb;
    const int t0 = blockIdx.x * MT;
    const int n_tile = w_merge - t0 < MT ? w_merge - t0 : MT;
    for (int r = blockIdx.y; r < rows; r += gridDim.y) {
        int* orow = merged + (long long)r * w_merge + t0;
        if (t0 >= total) {            // the whole block: padding only
            fill_pad(orow, n_tile);
            continue;
        }
        // the values first, then the old slice, which stays in flight
        // while the values are sorted
        stage(sb, vals + (long long)r * wb, wb, 0, wb);
        cp_async_commit();
        const int lo = t0 > wb ? t0 - wb : 0;
        const int hi = t0 + MT < wa ? t0 + MT : wa;
        const int a_off = stage(sa, old + (long long)r * wa, wa, lo, hi);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        bitonic_sort_shared(sb, wb);
        if (blockIdx.x == 0) store_tile(svals + (long long)r * wb, sb, wb);
        cp_async_wait<0>();
        __syncthreads();
        const int g = t0 + threadIdx.x * IPT;
        int v[IPT];
        const int i = g < total ? merge_path(sa, a_off, wa, sb, 0, wb, g) : wa;
        merge_run(sa, a_off, wa, sb, 0, wb, i, g - i, g, total, v);
        __syncthreads();
        write_tile(orow, sa, v, n_tile);
        __syncthreads();              // before the next row's staging
    }
}

inline bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

inline int sort_threads(int n) {
    int t = n >> 1;
    if (t > 1024) t = 1024;
    if (t < 32) t = 32;
    return t;
}

// The sort's dynamic shared memory above 48 KB: the opt-in for the largest
// tile, asked once per device and key type.
template <typename T>
cudaError_t allow_sort_shared(size_t bytes) {
    static bool granted[MAX_DEVICES];
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && granted[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(sort_tiles_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_TILE * sizeof(T)));
    if (err == cudaSuccess && dev < MAX_DEVICES) granted[dev] = true;
    return err;
}

template <typename T>
cudaError_t sort_tiles(const T* in, T* out, int rows, int width, int tile,
                       int width_pad, cudaStream_t stream) {
    const size_t bytes = (size_t)tile * sizeof(T);
    cudaError_t err = allow_sort_shared<T>(bytes);
    if (err != cudaSuccess) return err;
    sort_tiles_kernel<T><<<dim3(width_pad / tile, rows), sort_threads(tile),
                           bytes, stream>>>(in, out, width, tile, width_pad);
    return cudaGetLastError();
}

inline dim3 tile_grid(int w_out, int rows) {
    return dim3((unsigned)((w_out + MT - 1) / MT),
                (unsigned)(rows < 65535 ? rows : 65535));
}

template <typename T>
cudaError_t merge_rows(const T* a, long long a_stride, int wa, const T* b,
                       long long b_stride, int wb, T* out,
                       long long out_stride, int w_out, int rows,
                       cudaStream_t stream) {
    merge_tiles_kernel<T><<<tile_grid(w_out, rows), MT_THREADS, 0, stream>>>(
        a, a_stride, wa, b, b_stride, wb, out, out_stride, w_out, rows);
    return cudaGetLastError();
}

// Rows of `width` keys sorted into out (rows, width_pad), width_pad a
// power of two >= width, the padding key beyond width: tiles of up to
// MAX_TILE sorted in shared memory, then merged pairwise by the tile merge,
// one pass per doubling, through `scratch` (rows, width_pad) so that the
// last pass writes out (scratch is not read when one tile holds a row).
template <typename T>
cudaError_t sort_rows(const T* in, T* out, T* scratch, int rows, int width,
                      int width_pad, cudaStream_t stream) {
    const int tile = width_pad < MAX_TILE ? width_pad : MAX_TILE;
    int passes = 0;
    for (int run = tile; run < width_pad; run <<= 1) ++passes;
    if (passes > 0 && scratch == nullptr) return cudaErrorInvalidValue;
    T* buf = (passes & 1) ? scratch : out;
    T* other = (passes & 1) ? out : scratch;
    cudaError_t err = sort_tiles(in, buf, rows, width, tile, width_pad,
                                 stream);
    for (int run = tile; err == cudaSuccess && run < width_pad; run <<= 1) {
        // every adjacent pair of sorted runs of `run` keys -> 2 * run
        err = merge_rows(buf, 2LL * run, run, buf + run, 2LL * run, run,
                         other, 2LL * run, 2 * run,
                         rows * (width_pad / (2 * run)), stream);
        T* t = buf;
        buf = other;
        other = t;
    }
    return err;
}

}  // namespace

// Keys: key_type 0 = int32, 1 = float32 (every pointer points at that type).

// Sorts each row of in (rows, width) ascending into out (rows, width_pad),
// width_pad a power of two >= width, the padding key beyond width;
// `scratch` (rows, width_pad) when width_pad > 32768, else null.
extern "C" int bitonic_sort_rows(const void* in, void* out, void* scratch,
                                 int rows, int width, int width_pad,
                                 int key_type, void* stream) {
    if (rows <= 0 || width_pad <= 0) return (int)cudaSuccess;
    if (!is_pow2(width_pad) || width > width_pad || rows > 65535 ||
        key_type < 0 || key_type > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(key_type == 0
        ? sort_rows(static_cast<const int*>(in), static_cast<int*>(out),
                    static_cast<int*>(scratch), rows, width, width_pad, s)
        : sort_rows(static_cast<const float*>(in), static_cast<float*>(out),
                    static_cast<float*>(scratch), rows, width, width_pad,
                    s));
}

// Merges row r's ascending runs a[r*a_stride .. +wa) and b[r*b_stride ..
// +wb) into out[r*out_stride .. +w_out), the padding key beyond wa + wb
// (the tile merge: a grid over the rows' output tiles).
extern "C" int bitonic_merge_rows(const void* a, long long a_stride, int wa,
                                  const void* b, long long b_stride, int wb,
                                  void* out, long long out_stride, int w_out,
                                  int rows, int key_type, void* stream) {
    if (rows <= 0 || w_out <= 0) return (int)cudaSuccess;
    if (wa < 0 || wb < 0 || wa + wb > w_out || key_type < 0 || key_type > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(key_type == 0
        ? merge_rows(static_cast<const int*>(a), a_stride, wa,
                     static_cast<const int*>(b), b_stride, wb,
                     static_cast<int*>(out), out_stride, w_out, rows, s)
        : merge_rows(static_cast<const float*>(a), a_stride, wa,
                     static_cast<const float*>(b), b_stride, wb,
                     static_cast<float*>(out), out_stride, w_out, rows, s));
}

// The fused ship-batch pipeline: old (rows, w_old) ascending with int32.max
// tails, vals (rows, w_val) unsorted with int32.max tails, w_val a power of
// two -> svals (rows, w_val) sorted, merged (rows, w_merge) sorted, w_merge
// >= w_old + w_val. Up to SORT_IN_BLOCK values a row: one launch of the
// fused tile merge. Above: the row sort into svals (`scratch` as for
// bitonic_sort_rows), then the tile merge of old and svals - kernels on
// one stream, one call.
extern "C" int bitonic_apply(const int* old, int w_old, const int* vals,
                             int w_val, int* svals, int* merged, int w_merge,
                             int rows, int* scratch, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    if (!is_pow2(w_val) || w_old < 0 || w_old + w_val > w_merge)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (w_val <= SORT_IN_BLOCK) {
        const size_t bytes =
            (size_t)(((MT + w_val + 8 + 3) & ~3) + w_val) * sizeof(int);
        apply_tiles_kernel<<<tile_grid(w_merge, rows), MT_THREADS, bytes,
                             s>>>(old, w_old, vals, w_val, svals, merged,
                                  w_merge, rows);
        return (int)cudaGetLastError();
    }
    const cudaError_t err = sort_rows(vals, svals, scratch, rows, w_val,
                                      w_val, s);
    if (err != cudaSuccess) return (int)err;
    return (int)merge_rows(old, (long long)w_old, w_old,
                           (const int*)svals, (long long)w_val, w_val, merged,
                           (long long)w_merge, w_merge, rows, s);
}
