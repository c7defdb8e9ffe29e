// Blocked (flash) attention over a whole prompt: forward and backward.
//
// Replaces no Pallas kernel. The JAX package computes this function in
// src/repro/nn/flash.py:30 (`flash_attention`) as one jitted program, a
// nested `lax.scan` over (q blocks x kv blocks) with an online softmax;
// its docstring calls it the jnp twin of a Pallas flash kernel. The port's
// plain version of it (kernels/flash_attn/ops.py, `flash_attention_fwd_ref`)
// is a Python loop of about 25 small launches a block pair. Its gradient is
// jax.grad of the same scans in the JAX package; here it is a kernel of the
// port's own (`flash_attn_bwd_dq`, `flash_attn_bwd_dkdv`), as K17's
// backward is.
//
// What it computes. q (B, Sq, H, dh), k and v (B, Skv, Hkv, dh), all float32
// or all bf16, G = H / Hkv query heads a KV head. Per query row i and key j:
// s = (q_i . k_j) * dh^-1/2, then cap * tanh(s / cap) when cap > 0, then -1e30
// where the causal mask (j > i) or the sliding window (j <= i - window)
// masks it; softmax over j; out_i = sum_j p_ij v_j in q's type, and the
// float32 log-sum-exp lse_i = m_i + log l_i. Sums in float32.
//
// What bounds it on an H100. Operations: the forward's two products are
// 4 dh flops a (row, key) pair in the band, the backward's five (QK^T
// again, dO V^T, P^T dO, dS K, dS^T Q) 10 dh; the bytes (each input read
// once, each output written once) are far behind at every shape of the
// paths: at whisper's (2, 4,096, 8 heads, 64) the pairs alone are 0.27 G,
// 69 GFLOP a forward, 0.07 ms at the tensor cores' dense bf16 rate (989
// TFLOP/s), against 25 MB. Beside the products each pair takes one
// exponential (the backward two, one a pass) on the special-function
// units, 16 a cycle an SM: 0.27 G of them take about as long again. So
// the design keeps both units busy and everything else small.
//
// bf16, the paths' type: the tensor cores (`flash_*_wgmma_kernel`).
// - Every product is a `wgmma.mma_async` m64nNk16 (bf16 in, float32 sums),
//   written as inline PTX; a warpgroup of 128 threads owns 64 rows of the
//   accumulator. A product of two inputs (S = Q K^T, dP = dO V^T) reads
//   both from shared memory; a product with P or dS takes it from
//   registers in the accumulator's own layout, and reads the other operand
//   (V, K, Q or dO, stored as rows of dh) with the transpose flag.
// - Tiles sit in shared memory as bf16 in the 128-byte swizzle that wgmma
//   reads, in blocks of 64 columns (dh 112 padded to 128 with zeros). They
//   arrive by 16-byte `cp.async`, zero-filled past the ragged edges,
//   through a ring of two stages: the next tile loads while this one's
//   products run.
// - The online softmax runs in registers on the accumulator, in base 2
//   (log2 e folded into the scale); a row's max and sum close over the
//   four threads that share it.
// - Rounding. The forward splits P into P_hi = bf16(P) and P_lo = bf16(P -
//   P_hi) and adds both products into the float32 accumulator; the sum of
//   the unrounded P gives the log-sum-exp. An emulation of this rounding
//   in plain torch (tests/test_torch_flash_attn.py; N(0, 1) inputs, S up to
//   1,024, dh 64 and 256, causal, window, softcap 50) keeps every output
//   within 0.95 - 0.98 of the bound the card holds a bf16 output to
//   (2^-8 relative to the float32 answer, `must_be_close_bf16` in
//   chip_smoke.py), as float32 P does; bf16(P) alone leaves 19 - 22 % of
//   the outputs outside it, the worst 14 - 82 times over. The backward
//   rounds P and dS once each, within the bound for bf16 gradients.
// - Forward: two warpgroups own 128 query rows and walk the band's key
//   tiles of 64. dQ pass: two warpgroups own 128 query rows and walk the
//   key tiles of 32; it first forms D = rowsum(dO O) for its rows and
//   writes it. dK/dV pass: a block owns 64 keys of one KV head and walks
//   its G heads' query tiles of 64; warpgroup 0 forms S^T, P^T and dV +=
//   P^T dO, warpgroup 1 dP^T, takes P^T times the softcap's factor and the
//   scale through shared memory, and forms dS^T and dK += dS^T Q. The two
//   passes run seven products against the bound's five: the price of
//   summing dK and dV over the G heads inside one block, with no atomics,
//   the same bits every call.
// - Registers decide the speed as much as the products do: at dh 64 each
//   kernel fits 128 registers a thread, so that two blocks (16 warps) share
//   an SM and one block's softmax and waits run under the other's
//   products; each pass is slower at one block an SM.
//
// The reference's semantics, in both types: a masked score is the finite
// -1e30, so a masked key adds p = 1 only while the row's max is still
// -1e30, which the first score in the band wipes with alpha = 0; a key
// past Skv scores -inf; tile pairs wholly outside the causal / window
// band are skipped, which is exact because every row has a key in its
// band (the wrapper refuses a call where one has none); rows past Sq are
// not stored; softcap is cap tanh(s / cap), its backward 1 - tanh^2.
//
// float32: the CUDA cores (`flash_*_kernel`), kept for float32 callers,
// whose 2e-4 (output) and 1e-4 (gradients) tolerances bf16 operands cannot
// meet. A block of 256 threads, 16 row groups x 16 lanes, owns a tile of
// BR rows and walks the other operand's tiles of BC rows:
//
// - Both tiles sit in shared memory as float32, each row padded to dh + 1
//   floats, so the 16 lanes of a half-warp that read 16 different rows at
//   one column hit 16 different banks.
// - A thread owns BR / 16 rows and BC / 16 columns (lanes c, c + 16, ...) of
//   the score tile and the same rows times dh / 16 columns of the output
//   accumulator in registers; a row's max and sum close with four
//   shuffles inside its half-warp. The probabilities go through shared
//   memory to the product with V.
// - `expf`, `tanhf`, `logf`, no fast intrinsics; every dot product adds
//   its dh terms in order with `fmaf`.
// - Backward: the dQ pass (rows = queries, walking key tiles) first forms
//   D_i = sum_d dO_id O_id for its rows and writes it; the dK/dV pass
//   (rows = keys of one KV head, walking the G query heads' query tiles)
//   reads it. p = exp(s - lse) recomputed from the forward's lse; dS = p
//   (dP - D), times 1 - tanh^2 under a softcap, times the scale. dK and dV
//   are summed over the G heads of a group inside one block.
//
// Tiles: BR = 64, BC = 64 for dh 64, 112 and 128; at dh 256 the streamed
// tile is 32 rows (and the dK/dV pass's own 32) to keep the accumulators
// in registers and the tiles under the 227 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int THREADS = 256;            // 16 row groups x 16 lanes
constexpr int MAX_DEVICES = 64;
constexpr float MASKED = -1e30f;        // the reference's mask value

// the FMA kernels' loads and stores (their instances are float32 only)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}

// the sum (or max) of v over the 16 lanes of this thread's half-warp
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
    for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
    for (int o = 8; o; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// does the tile pair (query rows q0 .. q1, keys k0 .. k1) hold a pair in the
// band of some row
__device__ __forceinline__ bool visit(int q0, int q1, int k0, int k1,
                                      int causal, int window) {
    if (causal && k0 > q1) return false;
    if (window > 0 && k1 <= q0 - window) return false;
    return true;
}

__device__ __forceinline__ bool allowed(int i, int j, int causal,
                                        int window) {
    return (!causal || j <= i) && (window <= 0 || j > i - window);
}

// rows [0, rows) of a (row stride `stride`) operand into a shared tile of
// row stride DH + 1, float32; zeros past `valid` rows
template <int DH, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows,
                                          int valid) {
    for (int e = threadIdx.x; e < rows * DH; e += THREADS) {
        const int r = e / DH, d = e - r * DH;
        dst[r * (DH + 1) + d] =
            r < valid ? to_f(src[(long long)r * stride + d]) : 0.f;
    }
}

// score of (row i, key j) from the raw dot product: scaled, softcapped
// (tanh returned in *t for the backward's chain rule), masked
__device__ __forceinline__ float score(float dot, float scale, float cap,
                                       int i, int j, int causal, int window,
                                       float* t) {
    float x = dot * scale;
    if (cap > 0.f) {
        *t = tanhf(x / cap);
        x = cap * *t;
    }
    return allowed(i, j, causal, window) ? x : MASKED;
}

template <int DH, int BR, int BC>
struct Fwd {
    static constexpr int LD = DH + 1, LP = BC + 1;
    static constexpr size_t SMEM = sizeof(float) *
        (BR * LD + 2 * BC * LD + BR * LP);
};

template <int DH, int BR, int BC, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hkv,
                 int causal, int window, float scale, float cap) {
    constexpr int RM = BR / 16, CN = BC / 16, DJ = DH / 16;
    constexpr int LD = Fwd<DH, BR, BC>::LD, LP = Fwd<DH, BR, BC>::LP;
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Ks = Qs + BR * LD;
    float* Vs = Ks + BC * LD;
    float* Ps = Vs + BC * LD;
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    const int b = blockIdx.y / H, h = blockIdx.y - b * H;
    const int kh = h / (H / Hkv);
    const int q0 = blockIdx.x * BR, q1 = min(q0 + BR, Sq) - 1;
    const long long qs = (long long)H * DH, ks = (long long)Hkv * DH;
    load_tile<DH>(Qs, q + ((long long)b * Sq + q0) * qs + h * DH, qs, BR,
                  Sq - q0);
    float m[RM], l[RM], acc[RM][DJ];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        m[i] = MASKED;
        l[i] = 0.f;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
    }
    const int n_kv = (Skv + BC - 1) / BC;
    for (int t = 0; t < n_kv; ++t) {
        const int k0 = t * BC, k1 = min(k0 + BC, Skv) - 1;
        if (!visit(q0, q1, k0, k1, causal, window)) continue;
        __syncthreads();              // the last tile's readers are done
        const long long off = ((long long)b * Skv + k0) * ks + kh * DH;
        load_tile<DH>(Ks, k + off, ks, BC, Skv - k0);
        load_tile<DH>(Vs, v + off, ks, BC, Skv - k0);
        __syncthreads();
        float s[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DH; ++d) {
            float qa[RM], ka[CN];
#pragma unroll
            for (int i = 0; i < RM; ++i) qa[i] = Qs[(r * RM + i) * LD + d];
#pragma unroll
            for (int j = 0; j < CN; ++j) ka[j] = Ks[(c + 16 * j) * LD + d];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < CN; ++j)
                    s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int row = q0 + r * RM + i;
            float mx = MASKED;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                const int col = k0 + c + 16 * j;
                float tc;
                // a key past Skv is no key at all: p = 0 whatever the max
                s[i][j] = col < Skv ? score(s[i][j], scale, cap, row, col,
                                            causal, window, &tc)
                                    : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            const float m_new = fmaxf(m[i], half_max(mx));
            const float alpha = expf(m[i] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                ps += s[i][j];
                Ps[(r * RM + i) * LP + c + 16 * j] = s[i][j];
            }
            l[i] = l[i] * alpha + half_sum(ps);
            m[i] = m_new;
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < BC; ++kk) {
            float pa[RM], va[DJ];
#pragma unroll
            for (int i = 0; i < RM; ++i) pa[i] = Ps[(r * RM + i) * LP + kk];
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) va[jj] = Vs[kk * LD + c + 16 * jj];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int jj = 0; jj < DJ; ++jj)
                    acc[i][jj] = fmaf(pa[i], va[jj], acc[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = q0 + r * RM + i;
        if (row >= Sq) continue;
        T* o = out + ((long long)b * Sq + row) * qs + h * DH;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj)
            o[c + 16 * jj] = from_f<T>(acc[i][jj] / den);
        if (c == 0) lse[((long long)b * H + h) * Sq + row] = m[i] + logf(l[i]);
    }
}

template <int DH, int BR, int BC>
struct Dq {
    static constexpr int LD = DH + 1, LP = BC + 1;
    static constexpr size_t SMEM = sizeof(float) *
        (2 * BR * LD + 2 * BC * LD + BR * LP);
};

// dQ, and D = rowsum(dO * O) for the dK/dV pass
template <int DH, int BR, int BC, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Skv, int H, int Hkv,
                    int causal, int window, float scale, float cap) {
    constexpr int RM = BR / 16, CN = BC / 16, DJ = DH / 16;
    constexpr int LD = Dq<DH, BR, BC>::LD, LP = Dq<DH, BR, BC>::LP;
    extern __shared__ float smem[];
    float* Qs = smem;
    float* dOs = Qs + BR * LD;
    float* Ks = dOs + BR * LD;
    float* Vs = Ks + BC * LD;
    float* dSs = Vs + BC * LD;
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    const int b = blockIdx.y / H, h = blockIdx.y - b * H;
    const int kh = h / (H / Hkv);
    const int q0 = blockIdx.x * BR, q1 = min(q0 + BR, Sq) - 1;
    const long long qs = (long long)H * DH, ks = (long long)Hkv * DH;
    const long long qoff = ((long long)b * Sq + q0) * qs + h * DH;
    load_tile<DH>(Qs, q + qoff, qs, BR, Sq - q0);
    load_tile<DH>(dOs, dout + qoff, qs, BR, Sq - q0);
    __syncthreads();
    float L[RM], D[RM], acc[RM][DJ];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = q0 + r * RM + i;
        float part = 0.f;
        if (row < Sq) {
            const T* orow = o + qoff + (long long)(r * RM + i) * qs;
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj)
                part = fmaf(dOs[(r * RM + i) * LD + c + 16 * jj],
                            to_f(orow[c + 16 * jj]), part);
        }
        D[i] = half_sum(part);
        const long long at = ((long long)b * H + h) * Sq + row;
        L[i] = row < Sq ? lse[at] : 0.f;
        if (row < Sq && c == 0) delta[at] = D[i];
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
    }
    const int n_kv = (Skv + BC - 1) / BC;
    for (int t = 0; t < n_kv; ++t) {
        const int k0 = t * BC, k1 = min(k0 + BC, Skv) - 1;
        if (!visit(q0, q1, k0, k1, causal, window)) continue;
        __syncthreads();
        const long long off = ((long long)b * Skv + k0) * ks + kh * DH;
        load_tile<DH>(Ks, k + off, ks, BC, Skv - k0);
        load_tile<DH>(Vs, v + off, ks, BC, Skv - k0);
        __syncthreads();
        float s[RM][CN], dp[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
        for (int d = 0; d < DH; ++d) {
            float qa[RM], da[RM], ka[CN], va[CN];
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                qa[i] = Qs[(r * RM + i) * LD + d];
                da[i] = dOs[(r * RM + i) * LD + d];
            }
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                ka[j] = Ks[(c + 16 * j) * LD + d];
                va[j] = Vs[(c + 16 * j) * LD + d];
            }
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < CN; ++j) {
                    s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
                    dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
                }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int row = q0 + r * RM + i;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
                const int col = k0 + c + 16 * j;
                float ds = 0.f, tc = 0.f;
                if (row < Sq && col < Skv && allowed(row, col, causal, window)) {
                    const float p = expf(score(s[i][j], scale, cap, row, col,
                                               causal, window, &tc) - L[i]);
                    ds = p * (dp[i][j] - D[i]);
                    if (cap > 0.f) ds *= 1.f - tc * tc;
                    ds *= scale;
                }
                dSs[(r * RM + i) * LP + c + 16 * j] = ds;
            }
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < BC; ++kk) {
            float sa[RM], ka[DJ];
#pragma unroll
            for (int i = 0; i < RM; ++i) sa[i] = dSs[(r * RM + i) * LP + kk];
#pragma unroll
            for (int jj = 0; jj < DJ; ++jj) ka[jj] = Ks[kk * LD + c + 16 * jj];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int jj = 0; jj < DJ; ++jj)
                    acc[i][jj] = fmaf(sa[i], ka[jj], acc[i][jj]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = q0 + r * RM + i;
        if (row >= Sq) continue;
        T* g = dq + qoff + (long long)(r * RM + i) * qs;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) g[c + 16 * jj] = from_f<T>(acc[i][jj]);
    }
}

template <int DH, int BR, int BC>
struct Dkdv {
    static constexpr int LD = DH + 1, LP = BC + 1;
    static constexpr size_t SMEM = sizeof(float) *
        (2 * BR * LD + 2 * BC * LD + 2 * BR * LP + 2 * BC);
};

// dK and dV of one KV head's key tile, summed over its G query heads
template <int DH, int BR, int BC, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Skv, int H, int Hkv,
                      int causal, int window, float scale, float cap) {
    constexpr int RM = BR / 16, CN = BC / 16, DJ = DH / 16;
    constexpr int LD = Dkdv<DH, BR, BC>::LD, LP = Dkdv<DH, BR, BC>::LP;
    extern __shared__ float smem[];
    float* Ks = smem;
    float* Vs = Ks + BR * LD;
    float* Qs = Vs + BR * LD;
    float* dOs = Qs + BC * LD;
    float* Ps = dOs + BC * LD;
    float* dSs = Ps + BR * LP;
    float* Ls = dSs + BR * LP;
    float* Ds = Ls + BC;
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    const int b = blockIdx.y / Hkv, kh = blockIdx.y - b * Hkv;
    const int G = H / Hkv;
    const int k0 = blockIdx.x * BR, k1 = min(k0 + BR, Skv) - 1;
    const long long qs = (long long)H * DH, ks = (long long)Hkv * DH;
    const long long koff = ((long long)b * Skv + k0) * ks + kh * DH;
    load_tile<DH>(Ks, k + koff, ks, BR, Skv - k0);
    load_tile<DH>(Vs, v + koff, ks, BR, Skv - k0);
    float gk[RM][DJ], gv[RM][DJ];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) gk[i][jj] = gv[i][jj] = 0.f;
    const int n_q = (Sq + BC - 1) / BC;
    for (int g = 0; g < G; ++g) {
        const int h = kh * G + g;
        const long long lrow = ((long long)b * H + h) * Sq;
        for (int t = 0; t < n_q; ++t) {
            const int q0 = t * BC, q1 = min(q0 + BC, Sq) - 1;
            if (!visit(q0, q1, k0, k1, causal, window)) continue;
            __syncthreads();
            const long long qoff = ((long long)b * Sq + q0) * qs + h * DH;
            load_tile<DH>(Qs, q + qoff, qs, BC, Sq - q0);
            load_tile<DH>(dOs, dout + qoff, qs, BC, Sq - q0);
            for (int e = threadIdx.x; e < BC; e += THREADS) {
                const bool in = q0 + e < Sq;
                Ls[e] = in ? lse[lrow + q0 + e] : 0.f;
                Ds[e] = in ? delta[lrow + q0 + e] : 0.f;
            }
            __syncthreads();
            float s[RM][CN], dp[RM][CN];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
            for (int d = 0; d < DH; ++d) {
                float ka[RM], va[RM], qa[CN], da[CN];
#pragma unroll
                for (int i = 0; i < RM; ++i) {
                    ka[i] = Ks[(r * RM + i) * LD + d];
                    va[i] = Vs[(r * RM + i) * LD + d];
                }
#pragma unroll
                for (int j = 0; j < CN; ++j) {
                    qa[j] = Qs[(c + 16 * j) * LD + d];
                    da[j] = dOs[(c + 16 * j) * LD + d];
                }
#pragma unroll
                for (int i = 0; i < RM; ++i)
#pragma unroll
                    for (int j = 0; j < CN; ++j) {
                        s[i][j] = fmaf(qa[j], ka[i], s[i][j]);
                        dp[i][j] = fmaf(da[j], va[i], dp[i][j]);
                    }
            }
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const int key = k0 + r * RM + i;
#pragma unroll
                for (int j = 0; j < CN; ++j) {
                    const int row = q0 + c + 16 * j;
                    float p = 0.f, ds = 0.f, tc = 0.f;
                    if (key < Skv && row < Sq &&
                        allowed(row, key, causal, window)) {
                        p = expf(score(s[i][j], scale, cap, row, key, causal,
                                       window, &tc) - Ls[c + 16 * j]);
                        ds = p * (dp[i][j] - Ds[c + 16 * j]);
                        if (cap > 0.f) ds *= 1.f - tc * tc;
                        ds *= scale;
                    }
                    Ps[(r * RM + i) * LP + c + 16 * j] = p;
                    dSs[(r * RM + i) * LP + c + 16 * j] = ds;
                }
            }
            __syncthreads();
#pragma unroll 2
            for (int kk = 0; kk < BC; ++kk) {
                float pa[RM], sa[RM], oa[DJ], qa[DJ];
#pragma unroll
                for (int i = 0; i < RM; ++i) {
                    pa[i] = Ps[(r * RM + i) * LP + kk];
                    sa[i] = dSs[(r * RM + i) * LP + kk];
                }
#pragma unroll
                for (int jj = 0; jj < DJ; ++jj) {
                    oa[jj] = dOs[kk * LD + c + 16 * jj];
                    qa[jj] = Qs[kk * LD + c + 16 * jj];
                }
#pragma unroll
                for (int i = 0; i < RM; ++i)
#pragma unroll
                    for (int jj = 0; jj < DJ; ++jj) {
                        gv[i][jj] = fmaf(pa[i], oa[jj], gv[i][jj]);
                        gk[i][jj] = fmaf(sa[i], qa[jj], gk[i][jj]);
                    }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int key = k0 + r * RM + i;
        if (key >= Skv) continue;
        const long long at = koff + (long long)(r * RM + i) * ks;
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
            dk[at + c + 16 * jj] = from_f<T>(gk[i][jj]);
            dv[at + c + 16 * jj] = from_f<T>(gv[i][jj]);
        }
    }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

using BF16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; `bytes` 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy but the newest group has landed for every thread, and is
// visible to the tensor cores (which read shared memory in the async proxy)
__device__ __forceinline__ void tiles_landed() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
}

// rows [0, R) of a bf16 operand (row stride `stride` elements, `dh` columns)
// into a tile at `dst` in the 128-byte swizzle wgmma reads: DP / 64 column
// blocks of R rows x 128 bytes, the 16-byte chunk c of row r at byte
// ((c ^ r) & 7) * 16 of its row. Rows past `valid` and columns past `dh`
// are zero-filled.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_tile_sw(uint32_t dst, const BF16* src,
                                             long long stride, int valid,
                                             int dh) {
    constexpr int CH = DP / 8;
    static_assert((R * CH) % NT == 0, "whole passes of the block");
#pragma unroll
    for (int i = 0; i < R * CH / NT; ++i) {
        const int e = threadIdx.x + i * NT, r = e / CH, c = e % CH;
        const bool ok = r < valid && c * 8 < dh;
        cp_async16(dst + (c >> 3) * (R * 128) + r * 128 + (((c ^ r) & 7) << 4),
                   ok ? src + (long long)r * stride + c * 8 : src,
                   ok ? 16 : 0);
    }
}

// the wgmma descriptor of a 128-byte-swizzled operand at `addr`: 8-row
// groups 1,024 bytes apart (both offsets, so that it reads a K-major tile
// and, with the transpose flag, a 64-column block of an MN-major one)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    constexpr uint64_t GROUP = 1024 >> 4;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (GROUP << 16) | (GROUP << 32)
        | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D (64 x 32, float32) += A B^T, A (64 x 16) and B (32 x 16) bf16 read
// from shared memory through their descriptors; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
}

// D (64 x 64, float32) += A B^T, A (64 x 16) and B (64 x 16) bf16 read
// from shared memory through their descriptors; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d)
        : "memory");
}

// D (64 x 64, float32) += A B, A (64 x 16) bf16 from registers in the
// accumulator's row layout, B (16 x 64) bf16 in shared memory with its 64
// columns contiguous (the transpose flag)
__device__ __forceinline__ void wgmma_rs_t_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d)
        : "memory");
}


__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
    return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The accumulator of a 64 x N product: thread t of the warpgroup holds, for
// n-block j (8 columns), x[4j], x[4j + 1] at row 16 (t / 32) + (t % 32) / 4,
// columns 8j + 2 (t % 4) + {0, 1}, and x[4j + 2], x[4j + 3] at the row 8
// below. `a_frag` rounds k-slice kk of it (columns 16 kk .. 16 kk + 15) to
// bf16 in the layout of wgmma's register operand A.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&x)[N],
                                       int kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
        a[e] = bits(__floats2bfloat162_rn(x[8 * kk + 2 * e],
                                          x[8 * kk + 2 * e + 1]));
}

// the first and last of `n` tiles for which `in_band(t)` holds (the band's
// tiles are a run); lo > hi where none does
template <typename InBand>
__device__ __forceinline__ void band_tiles(int n, InBand in_band, int* lo,
                                           int* hi) {
    int a = 0, b = n - 1;
    while (a < n && !in_band(a)) ++a;
    while (b >= a && !in_band(b)) --b;
    *lo = a;
    *hi = b;
}

// is every pair of query rows q0 .. q1 and keys k0 .. k1 in the band (and
// every key a key)
__device__ __forceinline__ bool inside(int q0, int q1, int k0, int k1,
                                       int Skv, int causal, int window) {
    return k1 < Skv && (!causal || k1 <= q0) &&
           (window <= 0 || k0 > q1 - window);
}

// the score of a raw dot product in base 2 (times log2 e): scaled and
// softcapped; *f gets the backward's factor scale (1 - tanh^2)
__device__ __forceinline__ float score2(float dot, float scale, float cap,
                                        float* f) {
    if (cap > 0.f) {
        const float t = tanhf(dot * (scale / cap));
        *f = scale * (1.f - t * t);
        return cap * LOG2E * t;
    }
    *f = scale;
    return dot * (scale * LOG2E);
}

// Forward: a block of two warpgroups owns BR = 128 query rows (64 each)
// and walks the band's key tiles of BC = 64 through a ring of two stages.
template <int DH> struct FwdTc {
    static constexpr int DP = (DH + 63) / 64 * 64, NB = DP / 64;
    static constexpr int BR = 128, BC = 64, THREADS = 256;
    static constexpr int Q_BYTES = BR * DP * 2, KV_BYTES = BC * DP * 2;
    static constexpr size_t SMEM = 1024 + Q_BYTES + 4 * KV_BYTES;
    static constexpr int MIN_BLOCKS = DP == 64 ? 2 : 1;
};

template <int DH>
__global__ void __launch_bounds__(FwdTc<DH>::THREADS, FwdTc<DH>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const BF16* __restrict__ q, const BF16* __restrict__ k,
                       const BF16* __restrict__ v, BF16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Skv, int H,
                       int Hkv, int causal, int window, float scale,
                       float cap) {
    using C = FwdTc<DH>;
    constexpr int DP = C::DP, NB = C::NB, BR = C::BR, BC = C::BC;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t KVs = Qs + C::Q_BYTES;    // stage s: K, then V
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, cq = 2 * (lane & 3);
    const int b = blockIdx.y / H, h = blockIdx.y - b * H;
    const int kh = h / (H / Hkv);
    const int q0 = blockIdx.x * BR, q1 = min(q0 + BR, Sq) - 1;
    const long long qs = (long long)H * DH, ks = (long long)Hkv * DH;
    const long long kvoff = (long long)b * Skv * ks + kh * DH;
    int lo, hi;
    band_tiles((Skv + BC - 1) / BC, [&](int t) {
        return visit(q0, q1, t * BC, min(t * BC + BC, Skv) - 1, causal,
                     window);
    }, &lo, &hi);
    load_tile_sw<BR, DP, C::THREADS>(Qs, q + ((long long)b * Sq + q0) * qs
                                     + h * DH, qs, Sq - q0, DH);
    auto load_kv = [&](int t, int st) {
        const uint32_t dst = KVs + st * 2 * C::KV_BYTES;
        const long long off = kvoff + (long long)t * BC * ks;
        load_tile_sw<BC, DP, C::THREADS>(dst, k + off, ks, Skv - t * BC, DH);
        load_tile_sw<BC, DP, C::THREADS>(dst + C::KV_BYTES, v + off, ks,
                                         Skv - t * BC, DH);
    };
    if (lo <= hi) load_kv(lo, 0);
    cp_async_commit();
    // this thread's rows: r0 and r0 + 8; m in base 2, l over its columns
    const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
    const uint32_t Qa = Qs + 64 * wg * 128;
    float o[NB][32], m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
    for (int t = lo; t <= hi; ++t) {
        const int st = (t - lo) & 1, k0 = t * BC;
        if (t < hi) load_kv(t + 1, st ^ 1);
        cp_async_commit();
        tiles_landed();
        const uint32_t Ks = KVs + st * 2 * C::KV_BYTES, Vs = Ks + C::KV_BYTES;
        float s[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t in_row = (kk & 3) * 32;
            wgmma_ss(s, sw128_desc(Qa + (kk >> 2) * (BR * 128) + in_row),
                     sw128_desc(Ks + (kk >> 2) * (BC * 128) + in_row), kk > 0);
        }
        wg_commit_wait();
        pin(s);
        const bool all_in = inside(q0, q1, k0, k0 + BC - 1, Skv, causal,
                                   window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int row = r0 + ((i >> 1) & 1) * 8;
            const int col = k0 + (i >> 2) * 8 + cq + (i & 1);
            float f, x = score2(s[i], scale, cap, &f);
            // a key past Skv is no key at all: p = 0 whatever the max
            if (!all_in)
                x = col >= Skv ? -INFINITY
                    : allowed(row, col, causal, window) ? x : MASKED;
            s[i] = x;
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = quad_max(mx[r]);
            alpha[r] = ex2(m[r] - mx[r]);
            m[r] = mx[r];
            l[r] *= alpha[r];
        }
        // P = P_hi + P_lo, each bf16: the product sums both in float32
        uint32_t ph[BC / 16][4], pl[BC / 16][4];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            s[i] = ex2(s[i] - m[(i >> 1) & 1]);
            l[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x0 = s[8 * kk + 2 * e], x1 = s[8 * kk + 2 * e + 1];
                const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
                ph[kk][e] = bits(hb);
                pl[kk][e] = bits(__floats2bfloat162_rn(
                    x0 - __low2float(hb), x1 - __high2float(hb)));
            }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
            for (int i = 0; i < 32; ++i) o[nb][i] *= alpha[(i >> 1) & 1];
            pin(o[nb]);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
                const uint64_t dv = sw128_desc(Vs + nb * (BC * 128)
                                               + kk * (16 * 128));
                wgmma_rs_t_n64(o[nb], ph[kk], dv, 1);
                wgmma_rs_t_n64(o[nb], pl[kk], dv, 1);
            }
        wg_commit_wait();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) pin(o[nb]);
        __syncthreads();            // this stage is free for the next load
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const float sum = quad_sum(l[r]);
        if (row >= Sq) continue;
        BF16* orow = out + ((long long)b * Sq + row) * qs + h * DH;
        const float den = fmaxf(sum, 1e-30f);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = nb * 64 + j * 8 + cq;
                if (col < DH)
                    *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                        __floats2bfloat162_rn(o[nb][4 * j + 2 * r] / den,
                                              o[nb][4 * j + 2 * r + 1] / den);
            }
        if ((lane & 3) == 0)
            lse[((long long)b * H + h) * Sq + row] = m[r] * LN2 + logf(sum);
    }
}

// D = rowsum(dO * O) of query row `row`, the four threads of a quad
// summing every fourth 16-byte chunk
template <int DH>
__device__ __forceinline__ float row_delta(const BF16* dorow,
                                           const BF16* orow, int part) {
    float acc = 0.f;
#pragma unroll
    for (int c = part; c < DH / 8; c += 4) {
        const uint4 a = *reinterpret_cast<const uint4*>(dorow + c * 8);
        const uint4 bb = *reinterpret_cast<const uint4*>(orow + c * 8);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 u = __bfloat1622float2(x[e]);
            const float2 w = __bfloat1622float2(y[e]);
            acc = fmaf(u.x, w.x, acc);
            acc = fmaf(u.y, w.y, acc);
        }
    }
    return quad_sum(acc);
}

// The dQ pass: two warpgroups own BR = 128 query rows (64 each) and walk
// the band's key tiles of BC = 32 through a ring of two stages. The
// narrow tile keeps S and dP (16 values a thread each) beside dQ's
// accumulators: at dh 64 in 128 registers, two blocks an SM.
template <int DH> struct DqTc {
    static constexpr int DP = (DH + 63) / 64 * 64, NB = DP / 64;
    static constexpr int BR = 128, BC = 32, THREADS = 256;
    static constexpr int ROW_BYTES = BR * DP * 2, KV_BYTES = BC * DP * 2;
    static constexpr size_t SMEM = 1024 + 2 * ROW_BYTES + 4 * KV_BYTES;
    static constexpr int MIN_BLOCKS = DP == 64 ? 2 : 1;
};

template <int DH>
__global__ void __launch_bounds__(DqTc<DH>::THREADS, DqTc<DH>::MIN_BLOCKS)
flash_bwd_dq_wgmma_kernel(const BF16* __restrict__ q,
                          const BF16* __restrict__ k,
                          const BF16* __restrict__ v,
                          const BF16* __restrict__ o,
                          const BF16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, BF16* __restrict__ dq,
                          int Sq, int Skv, int H, int Hkv, int causal,
                          int window, float scale, float cap) {
    using C = DqTc<DH>;
    constexpr int DP = C::DP, NB = C::NB, BR = C::BR, BC = C::BC;
    constexpr int NS = BC / 2;           // a thread's values of S (and dP)
    extern __shared__ uint8_t smem_raw[];
    const uint32_t Qs = (smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t dOs = Qs + C::ROW_BYTES, KVs = dOs + C::ROW_BYTES;
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, cq = 2 * (lane & 3);
    const int b = blockIdx.y / H, h = blockIdx.y - b * H;
    const int kh = h / (H / Hkv);
    const int q0 = blockIdx.x * BR, q1 = min(q0 + BR, Sq) - 1;
    const long long qs = (long long)H * DH, ks = (long long)Hkv * DH;
    const long long qoff = ((long long)b * Sq + q0) * qs + h * DH;
    const long long kvoff = (long long)b * Skv * ks + kh * DH;
    int lo, hi;
    band_tiles((Skv + BC - 1) / BC, [&](int t) {
        return visit(q0, q1, t * BC, min(t * BC + BC, Skv) - 1, causal,
                     window);
    }, &lo, &hi);
    load_tile_sw<BR, DP, C::THREADS>(Qs, q + qoff, qs, Sq - q0, DH);
    load_tile_sw<BR, DP, C::THREADS>(dOs, dout + qoff, qs, Sq - q0, DH);
    auto load_kv = [&](int t, int st) {
        const uint32_t dst = KVs + st * 2 * C::KV_BYTES;
        const long long off = kvoff + (long long)t * BC * ks;
        load_tile_sw<BC, DP, C::THREADS>(dst, k + off, ks, Skv - t * BC, DH);
        load_tile_sw<BC, DP, C::THREADS>(dst + C::KV_BYTES, v + off, ks,
                                         Skv - t * BC, DH);
    };
    if (lo <= hi) load_kv(lo, 0);
    cp_async_commit();
    const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
    float L2[2], D[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const long long at = ((long long)b * H + h) * Sq + row;
        const long long off = ((long long)b * Sq + min(row, Sq - 1)) * qs
            + h * DH;
        D[r] = row_delta<DH>(dout + off, o + off, lane & 3);
        L2[r] = row < Sq ? lse[at] * LOG2E : 0.f;
        if (row < Sq && (lane & 3) == 0) delta[at] = D[r];
    }
    const uint32_t Qa = Qs + 64 * wg * 128, dOa = dOs + 64 * wg * 128;
    float g[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) g[nb][i] = 0.f;
    for (int t = lo; t <= hi; ++t) {
        const int st = (t - lo) & 1, k0 = t * BC;
        if (t < hi) load_kv(t + 1, st ^ 1);
        cp_async_commit();
        tiles_landed();
        const uint32_t Ks = KVs + st * 2 * C::KV_BYTES, Vs = Ks + C::KV_BYTES;
        float s[NS], dp[NS];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t a = (kk >> 2) * (BR * 128) + (kk & 3) * 32;
            const uint32_t bo = (kk >> 2) * (BC * 128) + (kk & 3) * 32;
            wgmma_ss(s, sw128_desc(Qa + a), sw128_desc(Ks + bo), kk > 0);
            wgmma_ss(dp, sw128_desc(dOa + a), sw128_desc(Vs + bo), kk > 0);
        }
        wg_commit_wait();
        pin(s);
        pin(dp);
        const bool all_in = inside(q0, q1, k0, k0 + BC - 1, Skv, causal,
                                   window) && q1 - q0 == BR - 1;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const int r = (i >> 1) & 1, row = r0 + 8 * r;
            const int col = k0 + (i >> 2) * 8 + cq + (i & 1);
            float ds = 0.f;
            if (all_in || (row < Sq && col < Skv &&
                           allowed(row, col, causal, window))) {
                float f;
                const float x = score2(s[i], scale, cap, &f);
                ds = ex2(x - L2[r]) * f * (dp[i] - D[r]);
            }
            s[i] = ds;
        }
        uint32_t a[BC / 16][4];
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk) a_frag(a[kk], s, kk);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) pin(g[nb]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
                wgmma_rs_t_n64(g[nb], a[kk], sw128_desc(
                    Ks + nb * (BC * 128) + kk * (16 * 128)), 1);
        wg_commit_wait();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) pin(g[nb]);
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= Sq) continue;
        BF16* grow = dq + ((long long)b * Sq + row) * qs + h * DH;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = nb * 64 + j * 8 + cq;
                if (col < DH)
                    *reinterpret_cast<__nv_bfloat162*>(grow + col) =
                        __floats2bfloat162_rn(g[nb][4 * j + 2 * r],
                                              g[nb][4 * j + 2 * r + 1]);
            }
    }
}

// The dK/dV pass: a block owns BR = 64 keys of one KV head and walks its G
// heads' query tiles (BC = 64) through a ring of two stages. Warpgroup 0
// forms S^T = K Q^T, P^T, and dV += P^T dO; warpgroup 1 forms dP^T = V
// dO^T, takes P^T (times the softcap's factor and the scale) through
// shared memory, and forms dS^T and dK += dS^T Q.
template <int DH> struct DkdvTc {
    static constexpr int DP = (DH + 63) / 64 * 64, NB = DP / 64;
    static constexpr int BR = 64, BC = 64, THREADS = 256;
    static constexpr int KV_BYTES = BR * DP * 2, ROW_BYTES = BC * DP * 2;
    // a stage: Q, dO, then the rows' lse and D (float32) in 1,024 bytes
    static constexpr int STAGE_BYTES = 2 * ROW_BYTES + 1024;
    static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + 2 * STAGE_BYTES
        + BR * BC * 4;
    static constexpr int MIN_BLOCKS = DP == 64 ? 2 : 1;
};

template <int DH>
__global__ void __launch_bounds__(DkdvTc<DH>::THREADS, DkdvTc<DH>::MIN_BLOCKS)
flash_bwd_dkdv_wgmma_kernel(const BF16* __restrict__ q,
                            const BF16* __restrict__ k,
                            const BF16* __restrict__ v,
                            const BF16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            BF16* __restrict__ dk, BF16* __restrict__ dv,
                            int Sq, int Skv, int H, int Hkv, int causal,
                            int window, float scale, float cap) {
    using C = DkdvTc<DH>;
    constexpr int DP = C::DP, NB = C::NB, BR = C::BR, BC = C::BC;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t Ks = (smem_addr(smem_raw) + 1023) & ~1023u;
    const uint32_t Vs = Ks + C::KV_BYTES, Stages = Vs + C::KV_BYTES;
    const uint32_t Pcs = Stages + 2 * C::STAGE_BYTES;
    uint8_t* const base = smem_raw + (Ks - smem_addr(smem_raw));
    float* const Pc = reinterpret_cast<float*>(base + (Pcs - Ks));
    const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
    const int warp = tw >> 5, lane = threadIdx.x & 31, cq = 2 * (lane & 3);
    const int b = blockIdx.y / Hkv, kh = blockIdx.y - b * Hkv;
    const int G = H / Hkv;
    const int k0 = blockIdx.x * BR, k1 = min(k0 + BR, Skv) - 1;
    const long long qs = (long long)H * DH, ks = (long long)Hkv * DH;
    const long long koff = ((long long)b * Skv + k0) * ks + kh * DH;
    int lo, hi;
    band_tiles((Sq + BC - 1) / BC, [&](int t) {
        return visit(t * BC, min(t * BC + BC, Sq) - 1, k0, k1, causal,
                     window);
    }, &lo, &hi);
    const int nt = hi - lo + 1, n_pairs = lo <= hi ? G * nt : 0;
    load_tile_sw<BR, DP, C::THREADS>(Ks, k + koff, ks, Skv - k0, DH);
    load_tile_sw<BR, DP, C::THREADS>(Vs, v + koff, ks, Skv - k0, DH);
    // (query head, query tile) pair p into stage st: Q, dO, lse, D
    auto load_q = [&](int p, int st) {
        const int gg = p / nt, q0 = (lo + p - gg * nt) * BC, h = kh * G + gg;
        const uint32_t dst = Stages + st * C::STAGE_BYTES;
        const long long off = ((long long)b * Sq + q0) * qs + h * DH;
        load_tile_sw<BC, DP, C::THREADS>(dst, q + off, qs, Sq - q0, DH);
        load_tile_sw<BC, DP, C::THREADS>(dst + C::ROW_BYTES, dout + off, qs,
                                         Sq - q0, DH);
        if (threadIdx.x < 2 * BC) {
            const int e = threadIdx.x & (BC - 1);
            const bool ok = q0 + e < Sq;
            const float* src = threadIdx.x < BC ? lse : delta;
            cp_async4(dst + 2 * C::ROW_BYTES + threadIdx.x * 4,
                      src + (ok ? ((long long)b * H + h) * Sq + q0 + e : 0),
                      ok ? 4 : 0);
        }
    };
    if (n_pairs) load_q(0, 0);
    cp_async_commit();
    const int r0 = k0 + 16 * warp + (lane >> 2);     // this thread's keys
    // warpgroup 0: S^T from K and Q, then dV from dO;
    // warpgroup 1: dP^T from V and dO, then dK from Q
    const uint32_t A1 = wg == 0 ? Ks : Vs;
    float acc[NB][32];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
    for (int p = 0; p < n_pairs; ++p) {
        const int st = p & 1, gg = p / nt, q0 = (lo + p - gg * nt) * BC;
        if (p + 1 < n_pairs) load_q(p + 1, st ^ 1);
        cp_async_commit();
        tiles_landed();
        const uint32_t Qt = Stages + st * C::STAGE_BYTES;
        const uint32_t dOt = Qt + C::ROW_BYTES;
        const float* Lt = reinterpret_cast<const float*>(
            base + (Qt - Ks) + 2 * C::ROW_BYTES);
        const float* Dt = Lt + BC;
        const uint32_t B1 = wg == 0 ? Qt : dOt, B2 = wg == 0 ? dOt : Qt;
        float x[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t in_row = (kk & 3) * 32;
            wgmma_ss(x, sw128_desc(A1 + (kk >> 2) * (BR * 128) + in_row),
                     sw128_desc(B1 + (kk >> 2) * (BC * 128) + in_row), kk > 0);
        }
        wg_commit_wait();
        pin(x);
        if (wg == 0) {
            const bool all_in = inside(q0, q0 + BC - 1, k0, k0 + BR - 1, Skv,
                                       causal, window) && q0 + BC <= Sq;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int key = r0 + ((i >> 1) & 1) * 8;
                const int c = (i >> 2) * 8 + cq + (i & 1), row = q0 + c;
                float pr = 0.f, f = 0.f;
                if (all_in || (key < Skv && row < Sq &&
                               allowed(row, key, causal, window)))
                    pr = ex2(score2(x[i], scale, cap, &f) - Lt[c] * LOG2E);
                Pc[i * 128 + tw] = pr * f;
                x[i] = pr;
            }
            asm volatile("bar.arrive 1, 256;\n" ::: "memory");
        } else {
            asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
            for (int i = 0; i < 32; ++i)
                x[i] = Pc[i * 128 + tw]
                    * (x[i] - Dt[(i >> 2) * 8 + cq + (i & 1)]);
        }
        uint32_t a[BC / 16][4];
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk) a_frag(a[kk], x, kk);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
                wgmma_rs_t_n64(acc[nb], a[kk], sw128_desc(
                    B2 + nb * (BC * 128) + kk * (16 * 128)), 1);
        wg_commit_wait();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) pin(acc[nb]);
        __syncthreads();        // the stage and the P^T exchange are free
    }
    BF16* const grad = wg == 0 ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int key = r0 + 8 * r;
        if (key >= Skv) continue;
        BF16* grow = grad + ((long long)b * Skv + key) * ks + kh * DH;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = nb * 64 + j * 8 + cq;
                if (col < DH)
                    *reinterpret_cast<__nv_bfloat162*>(grow + col) =
                        __floats2bfloat162_rn(acc[nb][4 * j + 2 * r],
                                              acc[nb][4 * j + 2 * r + 1]);
            }
    }
}

// a kernel's dynamic shared-memory limit raised to `bytes`, once a device
// (above 48 KB a launch is refused without it)
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes, bool* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

// the streamed tile's rows (and the dK/dV pass's own) by head_dim
template <int DH> struct Tiles {
    static constexpr int BR = 64, BC = DH == 256 ? 32 : 64;
    static constexpr int KR = DH == 256 ? 32 : 64, KC = DH == 256 ? 32 : 64;
};

struct Shape {
    int B, Sq, Skv, H, Hkv, causal, window;
    float scale, cap;
};

template <int DH, typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const Shape& s, cudaStream_t st) {
    constexpr int BR = Tiles<DH>::BR, BC = Tiles<DH>::BC;
    static bool done[MAX_DEVICES];
    auto kern = flash_fwd_kernel<DH, BR, BC, T>;
    constexpr size_t smem = Fwd<DH, BR, BC>::SMEM;
    cudaError_t err = prepare(kern, smem, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.Sq + BR - 1) / BR, s.B * s.H);
    kern<<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, s.Sq, s.Skv,
        s.H, s.Hkv, s.causal, s.window, s.scale, s.cap);
    return cudaGetLastError();
}

template <int DH, typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, const Shape& s, cudaStream_t st) {
    constexpr int BR = Tiles<DH>::BR, BC = Tiles<DH>::BC;
    static bool done[MAX_DEVICES];
    auto kern = flash_bwd_dq_kernel<DH, BR, BC, T>;
    constexpr size_t smem = Dq<DH, BR, BC>::SMEM;
    cudaError_t err = prepare(kern, smem, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.Sq + BR - 1) / BR, s.B * s.H);
    kern<<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), s.Sq,
        s.Skv, s.H, s.Hkv, s.causal, s.window, s.scale, s.cap);
    return cudaGetLastError();
}

template <int DH, typename T>
cudaError_t bwd_dkdv(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, const Shape& s, cudaStream_t st) {
    constexpr int BR = Tiles<DH>::KR, BC = Tiles<DH>::KC;
    static bool done[MAX_DEVICES];
    auto kern = flash_bwd_dkdv_kernel<DH, BR, BC, T>;
    constexpr size_t smem = Dkdv<DH, BR, BC>::SMEM;
    cudaError_t err = prepare(kern, smem, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.Skv + BR - 1) / BR, s.B * s.Hkv);
    kern<<<grid, THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), s.Sq, s.Skv, s.H, s.Hkv,
        s.causal, s.window, s.scale, s.cap);
    return cudaGetLastError();
}

// bf16: the tensor-core kernels' launches
template <int DH>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Shape& s, cudaStream_t st) {
    using C = FwdTc<DH>;
    using T = __nv_bfloat16;
    static bool done[MAX_DEVICES];
    auto kern = flash_fwd_wgmma_kernel<DH>;
    cudaError_t err = prepare(kern, C::SMEM, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.Sq + C::BR - 1) / C::BR, s.B * s.H);
    kern<<<grid, C::THREADS, C::SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, s.Sq, s.Skv,
        s.H, s.Hkv, s.causal, s.window, s.scale, s.cap);
    return cudaGetLastError();
}

template <int DH>
cudaError_t bwd_dq_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, const Shape& s,
                      cudaStream_t st) {
    using C = DqTc<DH>;
    using T = __nv_bfloat16;
    static bool done[MAX_DEVICES];
    auto kern = flash_bwd_dq_wgmma_kernel<DH>;
    cudaError_t err = prepare(kern, C::SMEM, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.Sq + C::BR - 1) / C::BR, s.B * s.H);
    kern<<<grid, C::THREADS, C::SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), s.Sq,
        s.Skv, s.H, s.Hkv, s.causal, s.window, s.scale, s.cap);
    return cudaGetLastError();
}

template <int DH>
cudaError_t bwd_dkdv_tc(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv,
                        const Shape& s, cudaStream_t st) {
    using C = DkdvTc<DH>;
    using T = __nv_bfloat16;
    static bool done[MAX_DEVICES];
    auto kern = flash_bwd_dkdv_wgmma_kernel<DH>;
    cudaError_t err = prepare(kern, C::SMEM, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.Skv + C::BR - 1) / C::BR, s.B * s.Hkv);
    kern<<<grid, C::THREADS, C::SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), s.Sq, s.Skv, s.H, s.Hkv,
        s.causal, s.window, s.scale, s.cap);
    return cudaGetLastError();
}

// the bf16 kernels copy 16-byte chunks of every bf16 operand
bool aligned16(std::initializer_list<const void*> ptrs) {
    for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) & 15) return false;
    return true;
}

bool shape_ok(const Shape& s, int d) {
    return s.B > 0 && s.Sq > 0 && s.Skv > 0 && s.Hkv > 0 && s.H % s.Hkv == 0
        && (d == 64 || d == 112 || d == 128 || d == 256)
        && (long long)s.B * s.H < 65536;
}

// one instance a (head_dim, type): F##_tc for bf16 (the tensor cores), F
// for float32 (the FMA kernels)
#define FLASH_DISPATCH(F, d, bf16, ...)                                      \
    switch (d) {                                                             \
    case 64: return (int)(bf16 ? F##_tc<64>(__VA_ARGS__)                     \
                               : F<64, float>(__VA_ARGS__));                 \
    case 112: return (int)(bf16 ? F##_tc<112>(__VA_ARGS__)                   \
                                : F<112, float>(__VA_ARGS__));               \
    case 128: return (int)(bf16 ? F##_tc<128>(__VA_ARGS__)                   \
                                : F<128, float>(__VA_ARGS__));               \
    default: return (int)(bf16 ? F##_tc<256>(__VA_ARGS__)                    \
                               : F<256, float>(__VA_ARGS__));                \
    }

}  // namespace

// q, out (B, Sq, H, d) and k, v (B, Skv, Hkv, d), contiguous, all float32 or
// all bf16 (`bf16`); lse (B, H, Sq) float32. d in {64, 112, 128, 256}; every
// query row must have a key in its band (the wrapper checks).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, float* lse, int B, int Sq, int Skv,
                              int H, int Hkv, int d, int bf16, int causal,
                              int window, float scale, float cap,
                              void* stream) {
    const Shape s{B, Sq, Skv, H, Hkv, causal, window, scale, cap};
    if (!shape_ok(s, d)) return (int)cudaErrorInvalidValue;
    if (bf16 && !aligned16({q, k, v, out}))
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    FLASH_DISPATCH(fwd, d, bf16, q, k, v, out, lse, s, st)
}

// The dQ pass: o and dout as q, lse from the forward; writes delta (B, H,
// Sq) float32, D = rowsum(dout * o), and dq as q. Launch it before
// `flash_attn_bwd_dkdv`, which reads delta.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const float* lse, float* delta, void* dq,
                                 int B, int Sq, int Skv, int H, int Hkv,
                                 int d, int bf16, int causal, int window,
                                 float scale, float cap, void* stream) {
    const Shape s{B, Sq, Skv, H, Hkv, causal, window, scale, cap};
    if (!shape_ok(s, d)) return (int)cudaErrorInvalidValue;
    if (bf16 && !aligned16({q, k, v, o, dout, dq}))
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    FLASH_DISPATCH(bwd_dq, d, bf16, q, k, v, o, dout, lse, delta, dq, s, st)
}

// The dK/dV pass: dk, dv as k, each KV head's gradient summed over its G
// query heads in one block.
extern "C" int flash_attn_bwd_dkdv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int B, int Sq,
                                   int Skv, int H, int Hkv, int d, int bf16,
                                   int causal, int window, float scale,
                                   float cap, void* stream) {
    const Shape s{B, Sq, Skv, H, Hkv, causal, window, scale, cap};
    if (!shape_ok(s, d)) return (int)cudaErrorInvalidValue;
    if (bf16 && !aligned16({q, k, v, dout, dk, dv}))
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    FLASH_DISPATCH(bwd_dkdv, d, bf16, q, k, v, dout, lse, delta, dk, dv, s,
                   st)
}
