// Mamba-1's causal depthwise conv with its bias and SiLU, and its backward.
//
// For x (B, T, D) with unit stride along D (the in-projection's first half
// is a strided view: rows 2 D apart), w (K, D) and b (D,):
//     pre[t] = b + sum_k w[k] * x[t - K + 1 + k]      (x[t < 0] = 0)
//     y[t]   = silu(pre[t]) = pre[t] / (1 + exp(-pre[t]))
// and, for the upstream gradient gy (B, T, D), with gp = gy * silu'(pre):
//     dx[t] = sum_k w[k] * gp[t + K - 1 - k]         (gp[t >= T] = 0)
//     dw[k] = sum_{b,t} gp[t] * x[t - K + 1 + k],    db = sum_{b,t} gp[t].
// Every product, sum and the SiLU run in float32 from the operands; each
// output is rounded once to the operands' type (bf16 or float32).
//
// Replaces no TPU kernel: the JAX package's conv (`repro/nn/mamba.py::
// _causal_conv`) is plain jnp that XLA fuses. The port's plain version
// (`kernels/causal_conv/ops.py::causal_conv_silu_ref`, the same chain)
// runs about a dozen bf16 elementwise launches forward and three dozen
// under autograd, each writing a (T, D) temporary that the next reads:
// about 28 (T, D) tensors of traffic forward and 61 backward.
//
// What bounds it on an H100: bytes. The forward reads x and writes y, the
// backward reads x and gy and writes dx: 4 and 6 bytes a bf16 element
// (0.040 and 0.060 ms at falcon-mamba-7b's (1, 4096, 8192, 4) at 3.35
// TB/s). About 12 float32 operations an element forward and 30 backward
// are far below the card's rate.
//
// What the design does about it: each byte is read and written once, and
// no temporary reaches device memory. A block takes TILE = 64 time steps
// of CH = 256 channels of one sequence and stages them into shared memory
// with `cp.async` (16-byte copies where the rows allow them, else one
// element a thread), the K - 1 rows of halo before the tile (and, backward,
// after it) included and zero-filled outside [0, T) and past D: every copy
// a block needs is in flight at once. Each thread then walks two channels
// down the tile with a sliding window of K rows in registers, writes its
// results over rows of the tile it has consumed, and the block stores the
// tile with 16-byte stores. w and b are read once a block. At B = 1 the
// (1, 4096, 8192) shape gives 2,048 blocks, several waves of 132 SMs.
//
// The backward recomputes pre in registers, forms gp, writes dx and sums
// dw and db over its tile's rows in float32 in order into a partial row of
// its own (no float atomics). A second, small launch adds the partials of
// every tile in a fixed order and rounds dw and db once: two launches a
// call, bit for bit repeatable.
//
// K is a template parameter; K = 4 (every configuration's d_conv) is the
// one instance. The element type is bf16 or float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;          // a block's threads, two channels each
constexpr int CH = 2 * THREADS;       // channels a block (ops.CHANNELS)
constexpr int TILE = 64;              // time steps a block (ops.TILE)
constexpr int RED_LANES = 8;          // the reduction's partial sums a channel
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename E> __device__ __forceinline__ E from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
    return __float2bfloat16_rn(v);
}

// Two neighbouring channels of a staged row (4- or 8-byte aligned: the
// thread's first channel is even, rows are CH elements).
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// 16 bytes from device to shared memory, or 16 zero bytes where `bytes` is
// 0 (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
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

// The SiLU and its derivative with the SFU's exponential and reciprocal
// (a few float32 ulps, far below a bf16 rounding; the accurate `expf` and
// an IEEE division made the forward issue-bound). For a large negative p
// the denominator is +inf and the result -0.
__device__ __forceinline__ float sigmoid(float p) {
    return __fdividef(1.0f, 1.0f + __expf(-p));
}

__device__ __forceinline__ float silu(float p) { return p * sigmoid(p); }

// silu'(p) = s (1 + p (1 - s)), s = sigmoid(p)
__device__ __forceinline__ float dsilu(float p) {
    const float s = sigmoid(p);
    return s * (1.0f + p * (1.0f - s));
}

// s[j][0 .. CH) = seq[t_first + j][c0 .. c0 + CH) for j < rows, 0 where
// the row lies outside [0, T) or the channel at or past D. With `vec`
// (16-byte aligned rows, D a multiple of a vector) as asynchronous 16-byte
// copies that the caller commits and waits for, else one element a
// thread. By the whole block; a __syncthreads must follow.
template <typename E>
__device__ __forceinline__ void stage(E* s, const E* seq, long long stride,
                                      int t_first, int rows, int T, int c0,
                                      int D, bool vec) {
    if (vec) {
        constexpr int V = 16 / sizeof(E);
        constexpr int CHUNKS = CH / V;
        for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
            const int j = i / CHUNKS, c = c0 + (i % CHUNKS) * V;
            const int t = t_first + j;
            const bool in = t >= 0 && t < T && c < D;
            cp_async16(s + i * V, in ? seq + t * stride + c : seq,
                       in ? 16 : 0);
        }
        return;
    }
    for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
        const int j = i / CH, c = c0 + i % CH;
        const int t = t_first + j;
        s[i] = (t >= 0 && t < T && c < D) ? seq[t * stride + c]
                                          : from_f<E>(0.0f);
    }
}

// out[t0 + j][c0 .. c0 + CH) = s[j][..] for the rows before T and the
// channels before D (out is contiguous, D wide), 16-byte stores with
// `vec`. By the whole block, after a __syncthreads.
template <typename E>
__device__ __forceinline__ void unstage(E* out, const E* s, int t0, int T,
                                        int c0, int D, bool vec) {
    const int rows = min(TILE, T - t0);
    if (vec) {
        constexpr int V = 16 / sizeof(E);
        constexpr int CHUNKS = CH / V;
        for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
            const int j = i / CHUNKS, c = c0 + (i % CHUNKS) * V;
            if (c < D)
                __stcs(reinterpret_cast<uint4*>(out + (long long)(t0 + j) * D
                                                + c),
                       *reinterpret_cast<const uint4*>(s + i * V));
        }
        return;
    }
    for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
        const int j = i / CH, c = c0 + i % CH;
        if (c < D) out[(long long)(t0 + j) * D + c] = s[i];
    }
}

// The thread's two channels' taps and bias in float32 (0 past D).
template <typename E, int K>
__device__ __forceinline__ void load_taps(const E* w, const E* b, int c,
                                          int D, float2 (&wk)[K],
                                          float2& bb) {
#pragma unroll
    for (int k = 0; k < K; ++k)
        wk[k] = make_float2(c < D ? to_f(w[k * D + c]) : 0.0f,
                            c + 1 < D ? to_f(w[k * D + c + 1]) : 0.0f);
    bb = make_float2(c < D ? to_f(b[c]) : 0.0f,
                     c + 1 < D ? to_f(b[c + 1]) : 0.0f);
}

// pre = b + sum_k w[k] * win[k], both channels
template <int K>
__device__ __forceinline__ float2 pre_of(const float2 (&wk)[K],
                                         const float2 (&win)[K], float2 bb) {
    float2 p = bb;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        p.x = fmaf(wk[k].x, win[k].x, p.x);
        p.y = fmaf(wk[k].y, win[k].y, p.y);
    }
    return p;
}

// grid (ceil(D / CH), ceil(T / TILE), B); shared memory TILE + K - 1 rows
// of CH elements: x's rows t0 - K + 1 .. t0 + TILE - 1, and y's rows
// t0 .. t0 + TILE - 1 written over them. The rows arrive in two groups,
// the first half's outputs computed while the second half is in flight.
template <typename E, int K>
__global__ void __launch_bounds__(THREADS)
causal_conv_fwd_kernel(const E* __restrict__ x, long long sb, long long sx,
                       const E* __restrict__ w, const E* __restrict__ b,
                       E* __restrict__ y, int T, int D, bool vec) {
    constexpr int H = TILE / 2;
    extern __shared__ __align__(16) unsigned char smem[];
    E* xs = reinterpret_cast<E*>(smem);
    const int c0 = blockIdx.x * CH, t0 = blockIdx.y * TILE;
    const E* seq = x + blockIdx.z * sb;
    stage(xs, seq, sx, t0 - (K - 1), H + K - 1, T, c0, D, vec);
    cp_async_commit();
    stage(xs + (H + K - 1) * CH, seq, sx, t0 + H, TILE - H, T, c0, D, vec);
    cp_async_commit();
    float2 wk[K], bb;
    const int cc = 2 * threadIdx.x;
    load_taps<E, K>(w, b, c0 + cc, D, wk, bb);
    float2 win[K];                        // x's rows r .. r + K - 1
    auto step = [&](int r) {
        win[K - 1] = load2(xs + (r + K - 1) * CH + cc);
        const float2 p = pre_of<K>(wk, win, bb);
        store2(xs + r * CH + cc, make_float2(silu(p.x), silu(p.y)));
#pragma unroll
        for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
    };
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K - 1; ++k) win[k] = load2(xs + k * CH + cc);
#pragma unroll 4
    for (int r = 0; r < H; ++r) step(r);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int r = H; r < TILE; ++r) step(r);
    __syncthreads();
    unstage(y + (long long)blockIdx.z * T * D, xs, t0, T, c0, D, vec);
}

// grid (ceil(D / CH), ceil(T / TILE), B); shared memory: x's rows
// t0 - K + 1 .. t0 + TILE + K - 2 (TILE + 2 (K - 1)), then gy's rows
// t0 .. t0 + TILE + K - 2 (TILE + K - 1), dx's rows t0 .. t0 + TILE - 1
// written over gy's. part: (B ceil(T / TILE), K + 1, Dp) float32, the
// tile's dw[0 .. K) and db. The rows arrive in two groups, as forward.
template <typename E, int K>
__global__ void __launch_bounds__(THREADS)
causal_conv_bwd_kernel(const E* __restrict__ x, long long sb, long long sx,
                       const E* __restrict__ w, const E* __restrict__ b,
                       const E* __restrict__ gy, E* __restrict__ dx,
                       float* __restrict__ part, int T, int D, int Dp,
                       bool vec) {
    constexpr int XROWS = TILE + 2 * (K - 1);
    extern __shared__ __align__(16) unsigned char smem[];
    E* xs = reinterpret_cast<E*>(smem);
    E* gs = xs + XROWS * CH;
    const int c0 = blockIdx.x * CH, t0 = blockIdx.y * TILE;
    constexpr int H = TILE / 2;
    const long long seq = (long long)blockIdx.z * T * D;
    const E* xq = x + blockIdx.z * sb;
    // steps r < H read x's rows < H + K - 1 and gy's rows < H
    stage(xs, xq, sx, t0 - (K - 1), H + K - 1, T, c0, D, vec);
    stage(gs, gy + seq, (long long)D, t0, H, T, c0, D, vec);
    cp_async_commit();
    stage(xs + (H + K - 1) * CH, xq, sx, t0 + H, XROWS - (H + K - 1), T, c0,
          D, vec);
    stage(gs + H * CH, gy + seq, (long long)D, t0 + H, TILE + K - 1 - H, T,
          c0, D, vec);
    cp_async_commit();
    float2 wk[K], bb;
    const int cc = 2 * threadIdx.x;
    load_taps<E, K>(w, b, c0 + cc, D, wk, bb);
    cp_async_wait<1>();
    __syncthreads();
    float2 xw[K];                         // x's rows r .. r + K - 1
    float2 gw[K];                         // gp's rows r - K + 1 .. r
    float2 dw[K], db = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
        dw[k] = gw[k] = make_float2(0.0f, 0.0f);
        if (k < K - 1) xw[k] = load2(xs + k * CH + cc);
    }
    // gp at row r (time t0 + r); from row K - 1 on, dx at row r - K + 1;
    // dw and db over the tile's own rows r < TILE
    auto step = [&](int r, bool own, bool emit) {
        xw[K - 1] = load2(xs + (r + K - 1) * CH + cc);
        const float2 p = pre_of<K>(wk, xw, bb);
        const float2 g = load2(gs + r * CH + cc);
#pragma unroll
        for (int k = 0; k < K - 1; ++k) gw[k] = gw[k + 1];
        gw[K - 1] = make_float2(g.x * dsilu(p.x), g.y * dsilu(p.y));
        if (own) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                dw[k].x = fmaf(gw[K - 1].x, xw[k].x, dw[k].x);
                dw[k].y = fmaf(gw[K - 1].y, xw[k].y, dw[k].y);
            }
            db.x += gw[K - 1].x;
            db.y += gw[K - 1].y;
        }
        if (emit) {
            float2 d = make_float2(0.0f, 0.0f);
#pragma unroll
            for (int k = 0; k < K; ++k) {
                d.x = fmaf(wk[k].x, gw[K - 1 - k].x, d.x);
                d.y = fmaf(wk[k].y, gw[K - 1 - k].y, d.y);
            }
            store2(gs + (r - (K - 1)) * CH + cc, d);   // gy's row, read
        }
#pragma unroll
        for (int k = 0; k < K - 1; ++k) xw[k] = xw[k + 1];
    };
#pragma unroll
    for (int r = 0; r < K - 1; ++r) step(r, true, false);
#pragma unroll 4
    for (int r = K - 1; r < H; ++r) step(r, true, true);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int r = H; r < TILE; ++r) step(r, true, true);
#pragma unroll
    for (int r = TILE; r < TILE + K - 1; ++r) step(r, false, true);
    float* row = part + ((long long)(blockIdx.z * gridDim.y + blockIdx.y)
                         * (K + 1)) * Dp + c0 + cc;
#pragma unroll
    for (int k = 0; k < K; ++k) store2(row + (long long)k * Dp, dw[k]);
    store2(row + (long long)K * Dp, db);
    __syncthreads();
    unstage(dx + seq, gs, t0, T, c0, D, vec);
}

// grid (ceil(D / 32), K + 1), block (32, RED_LANES): lane l adds the
// partials of tiles l, l + RED_LANES, ... in order, then lane 0 adds the
// lanes' sums in order and rounds once: dw[k] (k < K), else db.
template <typename E, int K>
__global__ void __launch_bounds__(32 * RED_LANES)
causal_conv_reduce_kernel(const float* __restrict__ part, int n_tiles,
                          int D, int Dp, E* __restrict__ dw,
                          E* __restrict__ db) {
    __shared__ float sums[RED_LANES][32];
    const int c = blockIdx.x * 32 + threadIdx.x, k = blockIdx.y;
    float s = 0.0f;
    if (c < D) {
        const float* p = part + (long long)k * Dp + c;
#pragma unroll 4
        for (int i = threadIdx.y; i < n_tiles; i += RED_LANES)
            s += p[(long long)i * (K + 1) * Dp];
    }
    sums[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && c < D) {
        float total = sums[0][threadIdx.x];
#pragma unroll
        for (int l = 1; l < RED_LANES; ++l) total += sums[l][threadIdx.x];
        (k < K ? dw + (long long)k * D : db)[c] = from_f<E>(total);
    }
}

constexpr int fwd_smem(int K, int esize) {
    return (TILE + K - 1) * CH * esize;
}
constexpr int bwd_smem(int K, int esize) {
    return (2 * TILE + 3 * (K - 1)) * CH * esize;
}

// The dynamic shared memory (above 48 KB only by this opt-in) and the
// carve-out at its maximum, so that the occupancy is the shared memory's
// (the default carve-out held one forward block an SM): asked once per
// device and kernel.
template <typename Kern>
cudaError_t prepare(Kern kernel, int bytes, bool (&done)[MAX_DEVICES]) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte copies: x's rows and the contiguous tensors' rows all start on
// 16-byte boundaries and a row holds whole vectors.
inline bool vec_rows(const void* x, long long sb, long long sx, int B, int D,
                     int esize, const void* a, const void* c) {
    const int V = 16 / esize;
    return aligned16(x) && aligned16(a) && aligned16(c) && sx % V == 0 &&
           (B == 1 || sb % V == 0) && D % V == 0;
}

inline bool grid_fits(int B, int T, int D) {
    return B >= 1 && T >= 1 && D >= 1 && B <= 65535 &&
           (T + TILE - 1) / TILE <= 65535;
}

template <typename E, int K>
cudaError_t prepare_fwd() {
    static bool done[MAX_DEVICES];
    return prepare(causal_conv_fwd_kernel<E, K>, fwd_smem(K, sizeof(E)),
                   done);
}

template <typename E, int K>
cudaError_t prepare_bwd() {
    static bool done[MAX_DEVICES];
    return prepare(causal_conv_bwd_kernel<E, K>, bwd_smem(K, sizeof(E)),
                   done);
}

template <typename E, int K>
cudaError_t fwd(const void* x, long long sb, long long sx, const void* w,
                const void* b, void* y, int B, int T, int D,
                cudaStream_t s) {
    const int smem = fwd_smem(K, sizeof(E));
    cudaError_t err = prepare_fwd<E, K>();
    if (err != cudaSuccess) return err;
    const dim3 grid((D + CH - 1) / CH, (T + TILE - 1) / TILE, B);
    causal_conv_fwd_kernel<E, K><<<grid, THREADS, smem, s>>>(
        static_cast<const E*>(x), sb, sx, static_cast<const E*>(w),
        static_cast<const E*>(b), static_cast<E*>(y), T, D,
        vec_rows(x, sb, sx, B, D, sizeof(E), y, y));
    return cudaGetLastError();
}

template <typename E, int K>
cudaError_t bwd(const void* x, long long sb, long long sx, const void* w,
                const void* b, const void* gy, void* dx, float* part,
                void* dw, void* db, int B, int T, int D, cudaStream_t s) {
    const int smem = bwd_smem(K, sizeof(E));
    cudaError_t err = prepare_bwd<E, K>();
    if (err != cudaSuccess) return err;
    const int Dp = (D + CH - 1) / CH * CH;
    const dim3 grid((D + CH - 1) / CH, (T + TILE - 1) / TILE, B);
    causal_conv_bwd_kernel<E, K><<<grid, THREADS, smem, s>>>(
        static_cast<const E*>(x), sb, sx, static_cast<const E*>(w),
        static_cast<const E*>(b), static_cast<const E*>(gy),
        static_cast<E*>(dx), part, T, D, Dp,
        vec_rows(x, sb, sx, B, D, sizeof(E), gy, dx));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    causal_conv_reduce_kernel<E, K>
        <<<dim3((D + 31) / 32, K + 1), dim3(32, RED_LANES), 0, s>>>(
            part, B * grid.y, D, Dp, static_cast<E*>(dw),
            static_cast<E*>(db));
    return cudaGetLastError();
}

template <typename E, int K>
cudaError_t occupancy(int bwd, int* blocks) {
    cudaError_t err = bwd ? prepare_bwd<E, K>() : prepare_fwd<E, K>();
    if (err != cudaSuccess) return err;
    return bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, causal_conv_bwd_kernel<E, K>, THREADS,
                     bwd_smem(K, sizeof(E)))
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, causal_conv_fwd_kernel<E, K>, THREADS,
                     fwd_smem(K, sizeof(E)));
}

}  // namespace

// The occupancy API's resident blocks an SM (of THREADS threads) of the
// forward (`bwd` 0) or the backward's tile kernel, bf16 or float32, K = 4.
extern "C" int causal_conv_occupancy(int bwd, int bf16, int* blocks) {
    if (!blocks) return (int)cudaErrorInvalidValue;
    return (int)(bf16 ? occupancy<__nv_bfloat16, 4>(bwd, blocks)
                      : occupancy<float, 4>(bwd, blocks));
}

// y (B, T, D), contiguous = silu(conv(x) + b) on `stream`. x: bf16 (`bf16`
// 1) or float32 rows of D elements, sb elements from one sequence to the
// next and sx from one step to the next; w (K, D) and b (D,) contiguous,
// of x's type. K = 4.
extern "C" int causal_conv_fwd(const void* x, long long sb, long long sx,
                               const void* w, const void* b, void* y, int B,
                               int T, int D, int K, int bf16, void* stream) {
    if (!x || !w || !b || !y || K != 4 || !grid_fits(B, T, D))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(bf16 ? fwd<__nv_bfloat16, 4>(x, sb, sx, w, b, y, B, T, D, s)
                      : fwd<float, 4>(x, sb, sx, w, b, y, B, T, D, s));
}

// dx (B, T, D) contiguous, dw (K, D) and db (D,) of x's type for the
// upstream gradient gy (B, T, D, contiguous), on `stream`: two launches,
// the tiles' partial sums into `part` ((B ceil(T / 64), K + 1, D rounded
// up to 256) float32) and their sum in a fixed order. Arguments as
// `causal_conv_fwd`.
extern "C" int causal_conv_bwd(const void* x, long long sb, long long sx,
                               const void* w, const void* b, const void* gy,
                               void* dx, float* part, void* dw, void* db,
                               int B, int T, int D, int K, int bf16,
                               void* stream) {
    if (!x || !w || !b || !gy || !dx || !part || !dw || !db || K != 4 ||
        !grid_fits(B, T, D))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(bf16 ? bwd<__nv_bfloat16, 4>(x, sb, sx, w, b, gy, dx, part,
                                              dw, db, B, T, D, s)
                      : bwd<float, 4>(x, sb, sx, w, b, gy, dx, part, dw, db,
                                      B, T, D, s));
}
