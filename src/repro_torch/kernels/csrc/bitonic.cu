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
// What bounds it on an H100: bytes in principle (each row is read once and
// written once, 2 * width * 4 bytes), but a batch has one row per touched
// column - a handful of rows - so a handful of thread blocks are all the
// parallelism there is and most of the card idles by construction. The
// design keeps each row's traffic to that one read and one write:
//   * the sort is a bitonic network over a tile held in shared memory
//     (one block per tile, up to 32768 values = 128 KB, which needs the
//     opt-in above 48 KB); a row wider than a tile is sorted tile by tile
//     and the tiles are merged pairwise by the merge kernel below;
//   * the merge does not run the half-cleaner stages at all: both inputs
//     are sorted, so every element finds its output slot as its own index
//     plus its rank in the other run (binary search). That is one pass at
//     any width - no stage needs the whole row in shared memory, so a
//     dictionary wider than 32768 entries merges against global memory by
//     the same code;
//   * the fused entry sorts a row's values in shared memory and merges
//     them with the old dictionary straight out of shared memory, one
//     launch per ship batch.
// The merged row equals the network's output because a sorted row is
// determined by its multiset, sentinels included. The sort and the merge of
// its tiles are templated on the key: int32 pads with int32.max, float32
// with NaN, the largest key of its order (NaN sorts after +inf, as in
// torch.sort and jnp.sort), so a row's real keys always come first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int I32MAX = 0x7fffffff;
constexpr int MAX_TILE = 32768;      // values sorted in one block's shared memory

// the padding key: the largest key of the order
template <typename T> __device__ __forceinline__ T pad_key();
template <> __device__ __forceinline__ int pad_key<int>() { return I32MAX; }
template <> __device__ __forceinline__ float pad_key<float>() {
    return __int_as_float(0x7fc00000);   // quiet NaN
}

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

// One (a, b) pair of ascending runs per row -> out[0..wa+wb) merged,
// out[wa+wb..w_out) = the padding key.
template <typename T>
__device__ __forceinline__ void rank_merge_row(const T* a, int wa,
                                               const T* b, int wb, T* out,
                                               int w_out, int first,
                                               int step) {
    for (int g = first; g < w_out; g += step) {
        T key;
        int pos;
        if (g < wa) {
            key = a[g];
            pos = g + lower_bound(b, wb, key);
        } else if (g < wa + wb) {
            const int j = g - wa;
            key = b[j];
            pos = j + upper_bound(a, wa, key);
        } else {
            key = pad_key<T>();
            pos = g;
        }
        out[pos] = key;
    }
}

template <typename T>
__global__ void merge_rows_kernel(const T* __restrict__ a, long long a_stride,
                                  int wa, const T* __restrict__ b,
                                  long long b_stride, int wb,
                                  T* __restrict__ out, long long out_stride,
                                  int w_out, int rows) {
    for (int r = blockIdx.y; r < rows; r += gridDim.y)
        rank_merge_row(a + r * a_stride, wa, b + r * b_stride, wb,
                       out + r * out_stride, w_out,
                       blockIdx.x * blockDim.x + threadIdx.x,
                       gridDim.x * blockDim.x);
}

__global__ void apply_kernel(const int* __restrict__ old, int w_old,
                             const int* __restrict__ vals, int w_val,
                             int* __restrict__ svals, int* __restrict__ merged,
                             int w_merge) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* s = reinterpret_cast<int*>(smem);
    const int r = blockIdx.x;
    const int* vrow = vals + (long long)r * w_val;
    for (int i = threadIdx.x; i < w_val; i += blockDim.x) s[i] = vrow[i];
    __syncthreads();
    bitonic_sort_shared(s, w_val);
    int* srow = svals + (long long)r * w_val;
    for (int i = threadIdx.x; i < w_val; i += blockDim.x) srow[i] = s[i];
    rank_merge_row(old + (long long)r * w_old, w_old, s, w_val,
                   merged + (long long)r * w_merge, w_merge, threadIdx.x,
                   blockDim.x);
}

inline bool is_pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

inline cudaError_t allow_shared(const void* kern, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    // above 48 KB a launch is refused unless the kernel opted in
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline int sort_threads(int n) {
    int t = n >> 1;
    if (t > 1024) t = 1024;
    if (t < 32) t = 32;
    return t;
}

template <typename T>
cudaError_t sort_tiles(const T* in, T* out, int rows, int width, int tile,
                       int width_pad, cudaStream_t stream) {
    const size_t bytes = (size_t)tile * sizeof(T);
    cudaError_t err = allow_shared(
        reinterpret_cast<const void*>(sort_tiles_kernel<T>), bytes);
    if (err != cudaSuccess) return err;
    sort_tiles_kernel<T><<<dim3(width_pad / tile, rows), sort_threads(tile),
                           bytes, stream>>>(in, out, width, tile, width_pad);
    return cudaGetLastError();
}

template <typename T>
cudaError_t merge_rows(const T* a, long long a_stride, int wa, const T* b,
                       long long b_stride, int wb, T* out,
                       long long out_stride, int w_out, int rows,
                       cudaStream_t stream) {
    int gx = (w_out + 255) / 256;
    if (gx > 2048) gx = 2048;
    const int gy = rows < 65535 ? rows : 65535;
    merge_rows_kernel<T><<<dim3(gx, gy), 256, 0, stream>>>(
        a, a_stride, wa, b, b_stride, wb, out, out_stride, w_out, rows);
    return cudaGetLastError();
}

}  // namespace

// Keys: key_type 0 = int32, 1 = float32 (every pointer points at that type).

// Sorts each `tile`-wide slice of every row ascending: in (rows, width),
// out (rows, width_pad), width_pad a multiple of tile, tile a power of two
// <= 32768; slots beyond `width` are filled with the padding key.
extern "C" int bitonic_sort_tiles(const void* in, void* out, int rows,
                                  int width, int tile, int width_pad,
                                  int key_type, void* stream) {
    if (rows <= 0 || width_pad <= 0) return (int)cudaSuccess;
    if (!is_pow2(tile) || tile > MAX_TILE || width_pad % tile != 0 ||
        width > width_pad || rows > 65535 || key_type < 0 || key_type > 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(key_type == 0
        ? sort_tiles(static_cast<const int*>(in), static_cast<int*>(out),
                     rows, width, tile, width_pad, s)
        : sort_tiles(static_cast<const float*>(in), static_cast<float*>(out),
                     rows, width, tile, width_pad, s));
}

// Merges row r's ascending runs a[r*a_stride .. +wa) and b[r*b_stride ..
// +wb) into out[r*out_stride .. +w_out), the padding key beyond wa + wb.
extern "C" int bitonic_merge_rows(const void* a, long long a_stride, int wa,
                                  const void* b, long long b_stride, int wb,
                                  void* out, long long out_stride, int w_out,
                                  int rows, int key_type, void* stream) {
    if (rows <= 0 || w_out <= 0) return (int)cudaSuccess;
    if (wa + wb > w_out || key_type < 0 || key_type > 1)
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

// The fused ship-batch pipeline, one block per row: old (rows, w_old)
// ascending with int32.max tails, vals (rows, w_val) unsorted with
// int32.max tails, w_val a power of two <= 32768 -> svals (rows, w_val)
// sorted, merged (rows, w_merge) sorted, w_merge >= w_old + w_val.
extern "C" int bitonic_apply(const int* old, int w_old, const int* vals,
                             int w_val, int* svals, int* merged, int w_merge,
                             int rows, void* stream) {
    if (rows <= 0) return (int)cudaSuccess;
    if (!is_pow2(w_val) || w_val > MAX_TILE || w_old + w_val > w_merge)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)w_val * sizeof(int);
    cudaError_t err =
        allow_shared(reinterpret_cast<const void*>(apply_kernel), bytes);
    if (err != cudaSuccess) return (int)err;
    apply_kernel<<<rows, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(
        old, w_old, vals, w_val, svals, merged, w_merge);
    return (int)cudaGetLastError();
}
