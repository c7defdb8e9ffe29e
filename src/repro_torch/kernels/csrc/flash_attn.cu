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
// float32 log-sum-exp lse_i = m_i + log l_i. All arithmetic in float32.
//
// What bounds it on an H100. Operations: 4 * dh flops a (row, key) pair in
// the band (two products), so 2 * B * H * pairs * dh multiply-adds, with
// the bytes (q, k, v read once, out written once) far behind at every
// shape of the paths: at whisper's (2, 4,096, 8 heads, 64) the pairs alone
// are 0.27 G, 69 GFLOP, against 25 MB. The bound counted at the tensor
// cores' bf16 rate (989 TFLOP/s) is the card's; these kernels run on the
// CUDA cores in float32 (67 TFLOP/s), which is their own ceiling.
//
// This design (simple and right first; a `wgmma` / TMA design is later
// work). A block of 256 threads, 16 row groups x 16 lanes, owns a tile of
// BR rows and walks the other operand's tiles of BC rows:
//
// - Both tiles sit in shared memory as float32 (bf16 is widened on the
//   load), each row padded to dh + 1 floats, so the 16 lanes of a half-warp
//   that read 16 different rows at one column hit 16 different banks.
// - A thread owns BR / 16 rows and BC / 16 columns (lanes c, c + 16, ...) of
//   the score tile and the same rows times dh / 16 columns of the output
//   accumulator in registers; a row's max and sum close with four
//   shuffles inside its half-warp. The probabilities go through shared
//   memory to the product with V.
// - Tile pairs wholly outside the causal / window band are skipped. That
//   gives the reference's answer: every row has a key in its band (the
//   wrapper refuses a call where one has none), and a masked score adds
//   p = 1 only while the row's max is still -1e30, which the first score
//   in the band wipes with alpha = exp(-1e30 - m) = 0.
// - `expf`, `tanhf`, `logf`, no fast intrinsics; every dot product adds
//   its dh terms in order with `fmaf`.
// - Backward: the dQ pass (rows = queries, walking key tiles) first forms
//   D_i = sum_d dO_id O_id for its rows and writes it; the dK/dV pass
//   (rows = keys of one KV head, walking the G query heads' query tiles)
//   reads it. p = exp(s - lse) recomputed from the forward's lse; dS = p
//   (dP - D), times 1 - tanh^2 under a softcap, times the scale. dK and dV
//   are summed over the G heads of a group inside one block: no atomics,
//   the same bits every call.
//
// Tiles: BR = 64, BC = 64 for dh 64, 112 and 128; at dh 256 the streamed
// tile is 32 rows (and the dK/dV pass's own 32) to keep the accumulators
// in registers and the tiles under the 227 KB of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;            // 16 row groups x 16 lanes
constexpr int MAX_DEVICES = 64;
constexpr float MASKED = -1e30f;        // the reference's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
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

bool shape_ok(const Shape& s, int d) {
    return s.B > 0 && s.Sq > 0 && s.Skv > 0 && s.Hkv > 0 && s.H % s.Hkv == 0
        && (d == 64 || d == 112 || d == 128 || d == 256)
        && (long long)s.B * s.H < 65536;
}

// one instance a (head_dim, type): F is the instance for DH and T
#define FLASH_DISPATCH(F, d, bf16, ...)                                      \
    switch (d) {                                                             \
    case 64: return (int)(bf16 ? F<64, __nv_bfloat16>(__VA_ARGS__)           \
                               : F<64, float>(__VA_ARGS__));                 \
    case 112: return (int)(bf16 ? F<112, __nv_bfloat16>(__VA_ARGS__)         \
                                : F<112, float>(__VA_ARGS__));               \
    case 128: return (int)(bf16 ? F<128, __nv_bfloat16>(__VA_ARGS__)         \
                                : F<128, float>(__VA_ARGS__));               \
    default: return (int)(bf16 ? F<256, __nv_bfloat16>(__VA_ARGS__)          \
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    FLASH_DISPATCH(bwd_dkdv, d, bf16, q, k, v, dout, lse, delta, dk, dv, s,
                   st)
}
