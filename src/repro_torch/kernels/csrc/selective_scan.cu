// Selective state-space scan (Mamba-1), the prefill recurrence.
//
// Replaces the TPU kernel `_scan_kernel` / `selective_scan_kernel`
// (kernels/selective_scan/selective_scan.py of the JAX package): for x, dt
// (B, T, D), A (D, N), B_t, C_t (B, T, N) and the skip D (D,), all float32,
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      (per channel)
//     y_t = <h_t, C_t> + D * x_t
// with h_0 = 0, returning y (B, T, D).
//
// What bounds it on an H100: not the bytes (x and dt read, y written: 12 B
// per (t, channel); 0.24 ms at falcon-mamba-7b's prefill (4, 2048, 8192,
// 16)), nor the B * T * D * N exponentials on the SFUs (16 a clock an SM:
// 0.26 ms at 1,980 MHz), but the instruction issue: the accurate `expf`
// is 8 instructions (one MUFU.EX2), and with its argument, the state's
// two multiplies and add and y's fused multiply-add a (t, channel, state)
// costs 13 - 0.42 ms at one instruction a clock per SM quarter.
//
// The time axis is a true recurrence, so a channel's state stays in
// registers for the whole sequence, as the TPU kernel keeps it in VMEM.
// Design:
// - Each channel's N states are split across L = 2 neighbouring lanes of
//   a warp: lane l carries states l*S .. l*S + S - 1 (S = N / 2). That
//   puts twice the threads in flight of a thread a channel (65,536 at the
//   prefill shape: 16 warps an SM, against 8) while the step's shared work
//   (x_t, dt_t, B_t and C_t from shared memory, the reduction of y_t, its
//   store) is paid once for S states. L = 2 measured fastest at the
//   prefill shape; 4 and 8 lanes repeat that shared work for more warps
//   and ran slower (PERF.md, K17).
//   Each lane updates its states exactly as the plain version rounds
//   them: `expf`, `__fmul_rn`, `__fadd_rn`, no FMA contraction (an FMA
//   there drifts from it over thousands of steps: 1e-4 at T = 2048), so h
//   is the plain version's h.
// - y_t: each lane sums h * C_t over its S states in order (a multiply,
//   then fused multiply-adds), the two partials are added across the
//   lanes by `__shfl_xor_sync` (offset 1), and lane 0 adds D * x_t and
//   writes y_t into a shared-memory tile, which the block writes out
//   after the tile with 16-byte stores.
//   Only this sum's order differs from the plain version's (within 3e-5).
// - A block holds CH = 32 neighbouring channels of one sequence (32 * L
//   threads) and walks T in tiles of TT = 16 steps. The tile's x and dt
//   (TT rows of 32 floats) and its B_t and C_t rows go into shared memory
//   with `cp.async` (16-byte copies where D % 4 == 0 and the pointers are
//   16-byte aligned, else 4-byte ones), double-buffered: tile k + 1 is in
//   flight while tile k computes. Steps past T are zero-filled (x = dt =
//   B = 0 leaves h as it is) so the time loop has the compile-time length
//   TT and unrolls; only the write-out is masked. (A 32-step tile ran
//   slower: twice the unrolled code for little less overhead.)
// - Blocks are independent (no carry between them, where the TPU grid
//   walked time blocks in order with the state in scratch). Any T, any D,
//   no padding; N in {4, 8, 16} (templates: the state stays in
//   registers).
//
// The gated form (`selective_scan_gated`, the instances with GATED true)
// takes Mamba's elementwise neighbours in, which otherwise run as bf16
// kernels of their own around a float32 scan (casts of x and dt and of y
// back, dt's bias and softplus, the silu(z) gate; about 66 ms of a 425 ms
// training step at falcon-mamba-7b's widths, PERF.md):
//     y = scan(x, softplus(dt_raw + dt_bias), A, B, C, D) * silu(z)
// with x, dt_raw, dt_bias, z and y of the activations' type (bf16, or
// float32), every operation in float32 and each output rounded once. x and
// dt_raw are staged as they are; when a tile has landed, each thread turns
// the dt_raw elements it copied into softplus(raw + bias) (once a (t,
// channel)); z is staged beside them (three buffers, as it is read after
// the tile's last barrier, in the write-out), and the write-out multiplies
// y_t by z * sigmoid(z). The recurrence is the plain form's; the plain
// instances keep their own staging and write-out (sharing the gated
// form's cost them 14 % at the training shape). Both lanes of a channel
// computing dt and the gate in the time loop ran 19 % slower there: the
// recurrence has few idle issue slots to give (PERF.md, K17). The gated
// form also writes the scan's output before the gate, y_pre, where the
// backward will need it (the backward summing it itself ran 14 % slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CH = 32;        // channels per block
constexpr int TT = 16;        // time steps per staged tile
constexpr int L = 2;          // lanes a channel's states are split across

// cp.async of BYTES (4 or 16) with zero-fill: `valid` false copies nothing
// and writes zeros (src must still be a valid address)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? BYTES : 0;
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(src), "r"(n) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(s), "l"(src), "r"(n) : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// S consecutive floats of shared memory (16-, 8- or 4-byte loads)
template <int S>
__device__ __forceinline__ void load_states(const float* p, float (&v)[S]) {
    if constexpr (S % 4 == 0) {
#pragma unroll
        for (int q = 0; q < S; q += 4) {
            const float4 f = *reinterpret_cast<const float4*>(p + q);
            v[q] = f.x; v[q + 1] = f.y; v[q + 2] = f.z; v[q + 3] = f.w;
        }
    } else if constexpr (S == 2) {
        const float2 f = *reinterpret_cast<const float2*>(p);
        v[0] = f.x; v[1] = f.y;
    } else {
#pragma unroll
        for (int q = 0; q < S; ++q) v[q] = p[q];
    }
}

// M consecutive elements of shared memory in float32 (16-byte loads where
// M fills them) and M floats back (16-byte stores)
template <int M>
__device__ __forceinline__ void load_row(const float* p, float (&v)[M]) {
    if constexpr (M % 4 == 0) {
#pragma unroll
        for (int q = 0; q < M; q += 4) {
            const float4 f = *reinterpret_cast<const float4*>(p + q);
            v[q] = f.x; v[q + 1] = f.y; v[q + 2] = f.z; v[q + 3] = f.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < M; ++q) v[q] = p[q];
    }
}

template <int M>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[M]) {
    if constexpr (M % 8 == 0) {
#pragma unroll
        for (int q = 0; q < M; q += 8) {
            const uint4 u = *reinterpret_cast<const uint4*>(p + q);
            const __nv_bfloat162* h =
                reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(h[i]);
                v[q + 2 * i] = f.x; v[q + 2 * i + 1] = f.y;
            }
        }
    } else {
#pragma unroll
        for (int q = 0; q < M; ++q) v[q] = __bfloat162float(p[q]);
    }
}

template <int M>
__device__ __forceinline__ void store_row(float* p, const float (&v)[M]) {
    if constexpr (M % 4 == 0) {
#pragma unroll
        for (int q = 0; q < M; q += 4)
            *reinterpret_cast<float4*>(p + q) =
                make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else {
#pragma unroll
        for (int q = 0; q < M; ++q) p[q] = v[q];
    }
}

// An element in float32, and float32 rounded (to nearest even) to an
// element
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

// dt = softplus(v) from its raw projection plus bias v as F.softplus
// computes it (v itself above the threshold 20, else log1p(exp(v)), with
// the accurate `expf` and `log1pf`), and its derivative sig = sigmoid(v) =
// e / (1 + e) (1 above the threshold). The SFU's `__expf` and `__logf`
// (a few 1e-6 relative) saved 0.09 ms of the forward's 1.05 at the
// training shape, but the recurrence carries dt's error into y: a bf16
// ulp from the float32 chain where y's terms cancel (PERF.md, K17).
struct Softplus {
    float dt, sig;
};

__device__ __forceinline__ Softplus softplus(float v) {
    const float e = expf(v);
    const bool above = v > 20.f;
    return {above ? v : log1pf(e), above ? 1.f : __fdividef(e, 1.f + e)};
}

// The gate's sigmoid with the SFU's exponential and reciprocal (as
// csrc/causal_conv.cu: a few float32 ulps, far below a bf16 rounding); for
// a large negative p the denominator is +inf and the result 0
__device__ __forceinline__ float sigmoid(float p) {
    return __fdividef(1.0f, 1.0f + __expf(-p));
}

// The gated form's further operands (the plain instances get zeros): dt's
// bias (D,); z, z[b][t][ch] at z + b * z_sb + t * z_st + ch (unit stride
// along D: the in-projection's second half is a strided view); y_pre, the
// scan's output before the gate (B, T, D), or null where no backward
// follows.
template <typename E>
struct Gate {
    const E* dt_bias;
    const E* z;
    long long z_sb, z_st;
    E* y_pre;
};

// The plain form (GATED false, E float): y = scan(x, dt, ...), float32 in
// and out. The gated form (E bf16 or float): dt = softplus(dt + dt_bias)
// from dt's raw projection, y = scan(x, dt, ...) * silu(z), operands and
// outputs of type E, every operation in float32, each output rounded once.
template <int N, bool VEC, bool GATED, typename E>
__global__ void __launch_bounds__(CH * L)
selective_scan_kernel(const E* __restrict__ x, const E* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ dskip, E* __restrict__ y,
                      const Gate<E> gate, int T, int D) {
    static_assert(GATED || std::is_same<E, float>::value,
                  "the plain scan is float32");
    constexpr int S = N / L;                       // states a lane
    constexpr int THREADS = CH * L;
    // the gated form stages a row of x, dt or z 16 bytes (VEC) or an
    // element at a time: EW elements a copy, CPR copies a row; a thread's
    // copies all lie in the same channels (THREADS is a multiple of CPR)
    constexpr int EW = VEC ? 16 / (int)sizeof(E) : 1;
    constexpr int CPR = CH / EW;
    constexpr int ZB = GATED ? 3 : 1;              // z's tile buffers
    __shared__ __align__(16) E sx[2][TT][CH];
    __shared__ __align__(16) E sdt[2][TT][CH];
    __shared__ __align__(16) float sb[2][TT * N];
    __shared__ __align__(16) float sc[2][TT * N];
    __shared__ __align__(16) float sy[TT][CH];
    // the gated form: a tile's dt, and z's tiles
    __shared__ __align__(16) float sdelta[GATED ? TT : 1][CH];
    __shared__ __align__(16) E sz[ZB][GATED ? TT : 1][CH];

    const int tid = threadIdx.x;
    const int c = tid / L, l = tid % L;            // channel in block, lane
    const int ch0 = blockIdx.x * CH;
    const int ch = ch0 + c;
    const bool live = ch < D;
    const long long row0 = (long long)blockIdx.y * T;   // (b, t = 0)

    float A[S], h[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
        A[i] = live ? a[(long long)ch * N + l * S + i] : 0.f;
        h[i] = 0.f;
    }
    const float dsk = live ? dskip[ch] : 0.f;
    // the gated form: dt's bias at this thread's staged channels
    float bias[EW];
#pragma unroll
    for (int e = 0; e < EW; ++e) {
        const int q = ch0 + (tid % CPR) * EW + e;
        bias[e] = GATED && q < D ? to_f(gate.dt_bias[q]) : 0.f;
    }

    // one copy of the gated form's staging: EW elements from src, or zeros
    auto copy = [&](E* dst, const E* src, bool ok) {
        if constexpr (VEC)
            cp_async<16>(dst, src, ok);
        else if constexpr (sizeof(E) == 4)
            cp_async<4>(dst, src, ok);
        else                                 // 2-byte elements: no cp.async
            *dst = ok ? *src : from_f<E>(0.f);
    };

    // tile k's x, dt, B_t, C_t (and z) into buffer `buf`, zero past T and D
    auto stage = [&](int k, int buf) {
        const int t0 = k * TT;
        if constexpr (GATED) {
            const long long z0 = (long long)blockIdx.y * gate.z_sb;
            for (int i = tid; i < TT * CPR; i += THREADS) {
                const int j = i / CPR, q = (i % CPR) * EW;
                const bool ok = t0 + j < T && ch0 + q < D;
                const long long at = ok ? (row0 + t0 + j) * D + ch0 + q : 0;
                const long long zt =
                    ok ? z0 + (t0 + j) * gate.z_st + ch0 + q : 0;
                copy(&sx[buf][j][q], x + at, ok);
                copy(&sdt[buf][j][q], dt + at, ok);
                copy(&sz[k % ZB][j][q], gate.z + zt, ok);
            }
        } else if constexpr (VEC) {
            constexpr int Q = CH / 4;              // 16-byte chunks a row
            for (int i = tid; i < TT * Q; i += THREADS) {
                const int j = i / Q, q = (i % Q) * 4;
                const bool ok = t0 + j < T && ch0 + q < D;
                const long long at = ok ? (row0 + t0 + j) * D + ch0 + q : 0;
                cp_async<16>(&sx[buf][j][q], x + at, ok);
                cp_async<16>(&sdt[buf][j][q], dt + at, ok);
            }
        } else {
            for (int i = tid; i < TT * CH; i += THREADS) {
                const int j = i / CH, q = i % CH;
                const bool ok = t0 + j < T && ch0 + q < D;
                const long long at = ok ? (row0 + t0 + j) * D + ch0 + q : 0;
                cp_async<4>(&sx[buf][j][q], x + at, ok);
                cp_async<4>(&sdt[buf][j][q], dt + at, ok);
            }
        }
        const int nb = min(TT, T - t0) * N;        // valid floats of B_t
        if constexpr (VEC) {
            for (int i = tid * 4; i < TT * N; i += THREADS * 4) {
                const bool ok = i < nb;
                const long long at = ok ? (row0 + t0) * N + i : 0;
                cp_async<16>(&sb[buf][i], bm + at, ok);
                cp_async<16>(&sc[buf][i], cm + at, ok);
            }
        } else {
            for (int i = tid; i < TT * N; i += THREADS) {
                const bool ok = i < nb;
                const long long at = ok ? (row0 + t0) * N + i : 0;
                cp_async<4>(&sb[buf][i], bm + at, ok);
                cp_async<4>(&sc[buf][i], cm + at, ok);
            }
        }
        cp_async_commit();
    };

    // the gated form: dt = softplus(raw + bias) in float32 for the elements
    // of tile k this thread staged (its own copies have landed), 0 past T
    // and D (a zero step leaves h as it is)
    auto delta = [&](int k, int buf) {
        const int t0 = k * TT;
        for (int i = tid; i < TT * CPR; i += THREADS) {
            const int j = i / CPR, q = (i % CPR) * EW;
            float v[EW];
            load_row<EW>(&sdt[buf][j][q], v);
#pragma unroll
            for (int e = 0; e < EW; ++e)
                v[e] = t0 + j < T && ch0 + q + e < D
                    ? softplus(v[e] + bias[e]).dt : 0.f;
            store_row<EW>(&sdelta[j][q], v);
        }
    };

    const int tiles = (T + TT - 1) / TT;
    stage(0, 0);
    for (int k = 0; k < tiles; ++k) {
        const int buf = k & 1;
        if (k + 1 < tiles) {
            // buffer buf ^ 1 was read last in tile k - 1 (synced); z's
            // buffer (k + 1) % 3 in tile k - 2's write-out, which every
            // thread finished before tile k - 1 landed
            stage(k + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        if constexpr (GATED) delta(k, buf);
        __syncthreads();                           // tile k has landed
        const int t0 = k * TT;
        const float* bt = sb[buf] + l * S;
        const float* ct = sc[buf] + l * S;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            const float xt = to_f(sx[buf][j][c]);
            float dtt;
            if constexpr (GATED) dtt = sdelta[j][c];
            else dtt = sdt[buf][j][c];
            const float dx = __fmul_rn(dtt, xt);
            float bv[S], cv[S];
            load_states<S>(bt + j * N, bv);
            load_states<S>(ct + j * N, cv);
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < S; ++i) {
                const float da = expf(__fmul_rn(dtt, A[i]));
                // rounded as the plain version rounds it: the state carries
                // its rounding through every later step
                h[i] = __fadd_rn(__fmul_rn(da, h[i]), __fmul_rn(dx, bv[i]));
                part = i == 0 ? __fmul_rn(h[i], cv[i])
                              : __fmaf_rn(h[i], cv[i], part);
            }
#pragma unroll
            for (int o = 1; o < L; o <<= 1)
                part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
            if (l == 0) sy[j][c] = __fadd_rn(part, __fmul_rn(dsk, xt));
        }
        __syncthreads();     // buffer `buf` is free for tile k + 2, sy full
        if constexpr (GATED) {
            for (int i = tid; i < TT * CPR; i += THREADS) {
                const int j = i / CPR, q = (i % CPR) * EW;
                if (t0 + j >= T || ch0 + q >= D) continue;
                const long long at = (row0 + t0 + j) * D + ch0 + q;
                // the gate in float32, each output rounded once
                float v[EW], zf[EW];
                load_row<EW>(&sy[j][q], v);
                load_row<EW>(&sz[k % ZB][j][q], zf);
                __align__(16) E out[EW], pre[EW];
#pragma unroll
                for (int e = 0; e < EW; ++e) {
                    out[e] = from_f<E>(v[e] * (zf[e] * sigmoid(zf[e])));
                    pre[e] = from_f<E>(v[e]);
                }
                if constexpr (VEC) {
                    *reinterpret_cast<uint4*>(y + at) =
                        *reinterpret_cast<const uint4*>(out);
                    if (gate.y_pre)
                        *reinterpret_cast<uint4*>(gate.y_pre + at) =
                            *reinterpret_cast<const uint4*>(pre);
                } else {
                    y[at] = out[0];
                    if (gate.y_pre) gate.y_pre[at] = pre[0];
                }
            }
        } else if constexpr (VEC) {
            constexpr int Q = CH / 4;
            for (int i = tid; i < TT * Q; i += THREADS) {
                const int j = i / Q, q = (i % Q) * 4;
                if (t0 + j < T && ch0 + q < D)
                    *reinterpret_cast<float4*>(y + (row0 + t0 + j) * D + ch0
                                               + q) =
                        *reinterpret_cast<const float4*>(&sy[j][q]);
            }
        } else {
            for (int i = tid; i < TT * CH; i += THREADS) {
                const int j = i / CH, q = i % CH;
                if (t0 + j < T && ch0 + q < D)
                    y[(row0 + t0 + j) * D + ch0 + q] = sy[j][q];
            }
        }
    }
}

template <int N, bool GATED, typename E>
cudaError_t launch(const E* x, const E* dt, const float* a, const float* bm,
                   const float* cm, const float* dskip, E* y,
                   const Gate<E>& g, int B, int T, int D, cudaStream_t s) {
    constexpr int V = 16 / (int)sizeof(E);         // elements a 16-byte copy
    const dim3 grid((D + CH - 1) / CH, B);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(x)
        | reinterpret_cast<uintptr_t>(dt) | reinterpret_cast<uintptr_t>(bm)
        | reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(y)
        | reinterpret_cast<uintptr_t>(g.z)
        | reinterpret_cast<uintptr_t>(g.y_pre);
    if (D % V == 0 && addr % 16 == 0 && g.z_sb % V == 0 && g.z_st % V == 0)
        selective_scan_kernel<N, true, GATED, E><<<grid, CH * L, 0, s>>>(
            x, dt, a, bm, cm, dskip, y, g, T, D);
    else
        selective_scan_kernel<N, false, GATED, E><<<grid, CH * L, 0, s>>>(
            x, dt, a, bm, cm, dskip, y, g, T, D);
    return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward pass: selective_scan_bwd
// ---------------------------------------------------------------------------
// Replaces no TPU kernel: the JAX package trains through its plain scan
// (kernels/selective_scan/ref.py:7, `selective_scan_ref`) and takes the
// gradient by autodiff; it has no Pallas backward. The port's forward is
// the kernel above, whose output has no autograd graph, so its gradient is
// this kernel (`SelectiveScan` in ../selective_scan/ops.py). For the
// upstream gradient gy (B, T, D), with da_t = exp(dt_t * A) and
// G_t = dL/dh_t = gy_t * C_t + da_{t+1} * G_{t+1} (reverse time, G after
// the last step 0), per channel and state:
//     gx_t  = D * gy_t + dt_t * sum_n G_t B_t
//     gdt_t = sum_n G_t * (A * da_t * h_{t-1} + x_t * B_t)
//     gA    = sum_{b,t} G_t * dt_t * da_t * h_{t-1}
//     gB_t  = sum_d G_t * dt_t * x_t          gC_t = sum_d gy_t * h_t
//     gD    = sum_{b,t} gy_t * x_t
//
// What bounds it on an H100: not the bytes (x, dt, gy read and gx, gdt
// written: 20 B per (t, channel); 0.20 ms at the training shape (1, 4096,
// 8192, 16)), nor the two exponentials owed on the SFUs (0.26 ms), but the
// instruction issue and the latencies behind it. The recurrence runs twice
// forward (the checkpoints, then a tile's states again) and once backward:
// about 68 SASS instructions per (t, channel, state) at N = 16 (a sweep-1
// tile 17, a sweep-2 tile's recompute and walk 45, its tile-end sums 6;
// the accurate `expf` is 8 of them; PERF.md, K17 bwd), 1.1 ms of issue at
// four a clock an SM. Every cross-lane sum is a shuffle or a shared-memory
// access (one warp a clock an SM), and the time loop is a chain of
// dependent steps whose latencies (`expf`, shuffles, shared memory) only
// warps in flight hide: at B = 1 there are only ceil(D / 32) blocks. It
// runs at about 70 % of its issue rate (PERF.md, K17 bwd).
//
// Design:
// - Lanes. Each channel's N states are spread over LB = bwd_lanes(N) lanes
//   of a warp: lane l carries states l*S .. l*S + S - 1 (S = N / LB) and
//   runs each state's recurrence alone, in the forward's order (`expf`,
//   `__fmul_rn`, `__fadd_rn`), so h is the forward kernel's h bit for bit.
//   A block holds CH = 32 channels of one sequence (32 * LB threads): at
//   N = 16 and LB = 8 two blocks of 8 warps an SM at B = 1, against about
//   4 warps an SM with the forward's two lanes. More lanes buy warps and
//   cost instructions: the per-(t, channel) work (x_t, dt_t, gy_t, the
//   gx / gdt sums, the store) is paid once for S states. At N = 16, 16
//   lanes (one state a lane, 32 warps an SM) measured slowest and 4 lanes
//   (8 warps an SM: 86 KB of shared memory leave two blocks) about 5 %
//   faster than 8, which is kept for its 16 warps an SM (PERF.md, K17 bwd).
// - Sweep 1 runs the recurrence over T and stores the state entering every
//   TT = 16-step tile in `ckpt` (B, ceil(T/TT), D, N). Sweep 2 walks the
//   tiles backwards: it recomputes the tile's states from its checkpoint
//   and keeps both h_t and da_t in shared memory, and the reverse walk reads
//   da_t there: two exponentials per (t, channel, state), the two owed.
//   Tiles of x, dt, gy, B_t and C_t are staged with `cp.async` (4-byte
//   copies from offsets fixed a thread, double-buffered, zero past T and
//   D: a zero step leaves h as it is and adds nothing to any gradient); the
//   next tile's checkpoint is loaded into registers a tile ahead.
// - gx_t, gdt_t (sums over the channel's N states): each lane sums its S
//   states, then the channel's LB lanes add their two partials by a
//   reduce-scatter (`scatter_sum`: the lower half of the lanes keeps the gx
//   partial, the upper the gdt partial, then an xor butterfly): log2(LB)
//   shuffles for both. Lanes 0 and LB/2 store them through a pointer that
//   steps back a row a step (an address rebuilt each step cost a fifth of
//   the walk's instructions).
// - gB_t, gC_t (sums over channels): the lane's 2S values (G dt x and gy h
//   of its states) are reduce-scattered over the warp's 32/LB channels
//   (lane bits 16 .. LB), which leaves each lane one (which, state) sum of
//   the warp (2N = 32 values, one a lane, at N = 16); the block's warps
//   are added in shared memory in warp order after the tile, one row per
//   block (`gb_part`, `gc_part` (n_blocks, B, T, N)).
// - gA and gD: each thread's sum over t (lane 0 alone for gD), written once
//   per (sequence, channel, state) (`ga_part` (B, D, N), `gd_part` (B, D)).
// - No float atomics: every sum has a fixed order (each level of a shuffle
//   tree adds a + b of two partners, so partners agree bit for bit), and
//   the wrapper adds the partials with `torch.sum` over their leading axis,
//   so two identical calls give identical bits.
// - Shared memory (`BwdSmem`): 94 KB at N = 16 (two blocks an SM; the
//   carve-out is set to its maximum), and registers capped so that 16
//   warps an SM fit where the shared memory allows (`MIN_BLOCKS`): no
//   instance spills.
// - The gated form (GATED true) is the backward of the gated forward for
//   the gradient g of its gated y. Both sweeps stage x and dt_raw as they
//   are (and, in sweep 2, g, z and the forward's y_pre) with 4-byte copies
//   (two bf16 channels a copy), and each thread turns what it copied into
//   the float32 tiles the plain form stages: x, dt = softplus(raw + bias)
//   exactly as the forward computes it, gy = g * silu(z); beside them
//   dt's sigmoid, and z's gradient g * y_pre * silu'(z), which needs
//   nothing of the walk and is written out there. The walk is the plain
//   form's; the lane that writes gdt_t writes gdt_t * sigmoid(raw + bias),
//   the raw projection's gradient, instead, and sums it over the sequence
//   for the bias (`gbias_part` (B, D), added by the wrapper).

// the backward's lanes a channel, by d_state: 4 at N = 4, 8 at 8 and 16
// (PERF.md, K17 bwd)
__host__ __device__ constexpr int bwd_lanes(int N) {
    return N == 4 ? 4 : 8;
}

// S consecutive floats into shared or global memory (16-, 8- or 4-byte
// stores)
template <int S>
__device__ __forceinline__ void store_states(float* p, const float (&v)[S]) {
    if constexpr (S % 4 == 0) {
#pragma unroll
        for (int q = 0; q < S; q += 4)
            *reinterpret_cast<float4*>(p + q) =
                make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
    } else if constexpr (S == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
        for (int q = 0; q < S; ++q) p[q] = v[q];
    }
}

// Adds the first M values of V across the lanes that differ in lane bit O,
// then O / 2, ..., LO. While a lane holds more than one value it keeps half
// of them at each level (the upper half where its bit O is set) and sends
// the other half to its partner: a reduce-scatter; once it holds one, an
// xor butterfly. Each sum is (own + partner's), so partners agree bit for
// bit, and the order is a fold in half over the lane bits, highest first.
template <int K, int M, int O, int LO>
__device__ __forceinline__ void scatter_sum(float (&V)[K], int lane) {
    if constexpr (O >= LO) {
        if constexpr (M > 1) {
            const bool up = lane & O;
#pragma unroll
            for (int v = 0; v < M / 2; ++v) {
                const float lo = V[v], hi = V[v + M / 2];
                V[v] = __fadd_rn(up ? hi : lo,
                                 __shfl_xor_sync(0xffffffffu, up ? lo : hi,
                                                 O));
            }
            scatter_sum<K, M / 2, O / 2, LO>(V, lane);
        } else {
            V[0] = __fadd_rn(V[0], __shfl_xor_sync(0xffffffffu, V[0], O));
            scatter_sum<K, 1, O / 2, LO>(V, lane);
        }
    }
}

// The index (of the M values) whose sum scatter_sum<K, M, O, LO> leaves in
// V[0] on `lane`
template <int M, int O, int LO>
__device__ __forceinline__ int scatter_index(int lane) {
    if constexpr (O >= LO && M > 1)
        return ((lane & O) ? M / 2 : 0)
            + scatter_index<M / 2, O / 2, LO>(lane);
    else
        return 0;
}

// The gated form's further operands and outputs (the plain instances get
// zeros): dt's bias (D,); z as the forward takes it; y_pre, the forward's
// output before the gate; gz, the gradient of z (B, T, D); gbias_part (B,
// D), each sequence's sum of the gradient of dt's raw projection; pairs:
// the 2-byte operands are staged two channels a 4-byte copy (D even, every
// row 4-byte aligned), else an element at a time.
template <typename E>
struct BwdGate {
    const E* dt_bias;
    const E* z;
    long long z_sb, z_st;
    const E* y_pre;
    E* gz;
    float* gbias_part;
    int pairs;
};

// dynamic shared memory of the backward kernel, in floats
template <int N, bool GATED, typename E>
struct BwdSmem {
    static constexpr int LB = bwd_lanes(N);
    static constexpr int S = N / LB;
    static constexpr int THREADS = CH * LB;
    static constexpr int WARPS = THREADS / 32;
    static constexpr int IN_ROW = TT * CH;      // x, dt, gy: a tile
    static constexpr int IN_BC = TT * N;        // B_t, C_t: a tile
    static constexpr int X = 0;
    static constexpr int DT = X + 2 * IN_ROW;
    static constexpr int GY = DT + 2 * IN_ROW;
    static constexpr int BB = GY + 2 * IN_ROW;
    static constexpr int CC = BB + 2 * IN_BC;
    static constexpr int DA = CC + 2 * IN_BC;            // [TT][THREADS][S]
    static constexpr int H = DA + TT * THREADS * S;      // [TT-1][THREADS][S]
    static constexpr int WP = H + (TT - 1) * THREADS * S;  // [TT][WARPS][2N]
    // the gated form: a tile of each operand as staged (x, dt's raw
    // projection, the upstream gradient, z, y_pre, of type E), dt's
    // sigmoid a tile, dt's bias at the block's channels
    static constexpr int RAW = WP + TT * WARPS * 2 * N;
    static constexpr int RAW_TILE = GATED ? IN_ROW * (int)sizeof(E) / 4 : 0;
    static constexpr int SIG = RAW + 5 * RAW_TILE;
    static constexpr int BIAS = SIG + (GATED ? IN_ROW : 0);
    static constexpr int FLOATS = BIAS + (GATED ? CH : 0);
    static constexpr int BYTES = FLOATS * 4;
    // blocks an SM that ptxas must leave registers for: 16 warps an SM or
    // more, as many blocks as an SM's 228 KB of shared memory holds (1 KB
    // of it reserved a block)
    static constexpr int SM_BLOCKS = 233472 / (BYTES + 1024);
    static constexpr int WARP_BLOCKS = 512 / THREADS > 2 ? 512 / THREADS : 2;
    static constexpr int MIN_BLOCKS =
        WARP_BLOCKS < SM_BLOCKS ? WARP_BLOCKS : SM_BLOCKS;
};

// The plain form (GATED false, E float): the gradients of sum(y * gy) for
// y = scan(x, dt, ...). The gated form (E bf16 or float): dt is dt's raw
// projection, gy the gradient of y = scan(x, softplus(dt + bias), ...) *
// silu(z); gdt receives the raw projection's gradient, gate.gz z's, and
// gate.gbias_part the bias's partial sums.
template <int N, bool GATED, typename E>
__global__ void __launch_bounds__(CH * bwd_lanes(N),
                                  BwdSmem<N, GATED, E>::MIN_BLOCKS)
selective_scan_bwd_kernel(const E* __restrict__ x,
                          const E* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ dskip,
                          const E* __restrict__ gy,
                          E* __restrict__ gx, E* __restrict__ gdt,
                          float* __restrict__ ga_part,
                          float* __restrict__ gb_part,
                          float* __restrict__ gc_part,
                          float* __restrict__ gd_part,
                          float* __restrict__ ckpt, const BwdGate<E> gate,
                          int B, int T, int D) {
    static_assert(GATED || std::is_same<E, float>::value,
                  "the plain scan is float32");
    using M = BwdSmem<N, GATED, E>;
    constexpr int LB = M::LB, S = M::S, THREADS = M::THREADS;
    constexpr int WARPS = M::WARPS;
    constexpr int HALF = LB / 2;
    extern __shared__ __align__(16) float smem[];
    float* sx = smem + M::X;
    float* sdt = smem + M::DT;
    float* sgy = smem + M::GY;
    float* sb = smem + M::BB;
    float* sc = smem + M::CC;
    float* sda = smem + M::DA;
    float* sh = smem + M::H;
    float* swp = smem + M::WP;
    E* const rx = reinterpret_cast<E*>(smem + M::RAW);
    E* const rdt = rx + M::IN_ROW;
    E* const rgy = rdt + M::IN_ROW;
    E* const rz = rgy + M::IN_ROW;
    E* const ryp = rz + M::IN_ROW;
    float* ssig = smem + M::SIG;
    float* sbias = smem + M::BIAS;

    const int tid = threadIdx.x;
    const int c = tid / LB, l = tid % LB;
    const int lane = tid & 31, warp = tid / 32;
    const int ch0 = blockIdx.x * CH;
    const int ch = ch0 + c;
    const bool live = ch < D;
    const int bidx = blockIdx.y;
    const long long row0 = (long long)bidx * T;
    const int tiles = (T + TT - 1) / TT;
    // this lane's (gB or gC, state) after the sums over the warp's channels
    const int wp_at = [&] {
        const int v = scatter_index<2 * S, 16, LB>(lane);
        return (v < S ? 0 : N) + l * S + v % S;
    }();

    float A[S];
#pragma unroll
    for (int i = 0; i < S; ++i)
        A[i] = live ? a[(long long)ch * N + l * S + i] : 0.f;
    const float dsk = live ? dskip[ch] : 0.f;
    const long long ck = (long long)(live ? ch : 0) * N + l * S;
    const long long ck_tile = (long long)D * N;
    if constexpr (GATED) {
        if (tid < CH)
            sbias[tid] = ch0 + tid < D ? to_f(gate.dt_bias[ch0 + tid]) : 0.f;
        __syncthreads();
    }

    // tile k into buffer `buf`: x, dt and B_t always, gy and C_t for the
    // reverse sweep; zero past T and D. This thread copies rows jr + m * LB
    // (m < TT / LB) of column q of x, dt and gy, and floats tid + m *
    // THREADS of B_t and C_t; its offsets are fixed, only the tile moves.
    const int q = tid % CH, jr = tid / CH;
    const bool q_live = ch0 + q < D;
    const long long in0 = (row0 + jr) * D + ch0 + q;
    // The gated form stages its operands as they are (one tile, `rx` ..
    // `ryp`), EPW elements a 4-byte copy: this thread copies rows gj + m *
    // RSTEP (m < GCOPIES) at channels gq .. gq + EPW of each, then turns
    // them into the float32 tiles the walks read (`convert`).
    constexpr int EPW = 4 / (int)sizeof(E);
    constexpr int RSTEP = THREADS / (CH / EPW);
    constexpr int GCOPIES = TT / RSTEP;
    const int gq = (tid % (CH / EPW)) * EPW, gj = tid / (CH / EPW);
    const bool gq_live = ch0 + gq < D;   // with pairs, both channels
    const long long gin0 = row0 * D + ch0 + gq;
    const E* const zq = GATED ? gate.z + bidx * gate.z_sb + ch0 + gq : nullptr;
    auto stage = [&](int k, int buf, bool rev) {
        const int t0 = k * TT;
        if constexpr (GATED) {
#pragma unroll
            for (int m = 0; m < GCOPIES; ++m) {
                const int j = gj + m * RSTEP, t = t0 + j, o = j * CH + gq;
                if (gate.pairs) {
                    const bool ok = gq_live && t < T;
                    const long long at = ok ? gin0 + (long long)t * D : 0;
                    cp_async<4>(rx + o, x + at, ok);
                    cp_async<4>(rdt + o, dt + at, ok);
                    if (rev) {
                        cp_async<4>(rgy + o, gy + at, ok);
                        cp_async<4>(ryp + o, gate.y_pre + at, ok);
                        cp_async<4>(rz + o, ok ? zq + t * gate.z_st : gate.z,
                                    ok);
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < EPW; ++e) {
                        const bool ok = gq + e < D - ch0 && t < T;
                        const long long at = gin0 + (long long)t * D + e;
                        const E zero = from_f<E>(0.f);
                        rx[o + e] = ok ? x[at] : zero;
                        rdt[o + e] = ok ? dt[at] : zero;
                        if (rev) {
                            rgy[o + e] = ok ? gy[at] : zero;
                            ryp[o + e] = ok ? gate.y_pre[at] : zero;
                            rz[o + e] = ok ? zq[t * gate.z_st + e] : zero;
                        }
                    }
                }
            }
        } else {
            const long long at0 = in0 + (long long)t0 * D;
#pragma unroll
            for (int m = 0; m < TT / LB; ++m) {
                const bool ok = q_live && t0 + jr + m * LB < T;
                const long long at = ok ? at0 + (long long)m * LB * D : 0;
                const int o = buf * M::IN_ROW + tid + m * THREADS;
                cp_async<4>(sx + o, x + at, ok);
                cp_async<4>(sdt + o, dt + at, ok);
                if (rev) cp_async<4>(sgy + o, gy + at, ok);
            }
        }
        const int nb = min(TT, T - t0) * N;
        const long long bc0 = (row0 + t0) * N;
#pragma unroll
        for (int m = 0; m < (TT * N + THREADS - 1) / THREADS; ++m) {
            const int i = tid + m * THREADS;
            if (TT * N % THREADS == 0 || i < TT * N) {
                const bool ok = i < nb;
                const long long at = ok ? bc0 + i : 0;
                const int o = buf * M::IN_BC + i;
                cp_async<4>(sb + o, bm + at, ok);
                if (rev) cp_async<4>(sc + o, cm + at, ok);
            }
        }
        cp_async_commit();
    };

    // The gated form: tile k's operands, as this thread staged them (its
    // own copies have landed), into the float32 tiles in buffer `buf`: x;
    // dt = softplus(raw + bias), 0 past T and D (a zero step leaves h as
    // it is and adds nothing to any gradient), exactly as the forward; for
    // the reverse sweep gy = g * silu(z), dt's sigmoid (the softplus's
    // derivative, 1 above its threshold), and z's gradient g * y_pre *
    // silu'(z), written out here.
    auto convert = [&](int k, int buf, bool rev) {
        const int t0 = k * TT;
#pragma unroll
        for (int m = 0; m < GCOPIES; ++m) {
            const int j = gj + m * RSTEP, t = t0 + j, o = j * CH + gq;
            __align__(4) E gzv[EPW];
#pragma unroll
            for (int e = 0; e < EPW; ++e) {
                const bool ok = t < T && gq + e < D - ch0;
                const Softplus sp = softplus(to_f(rdt[o + e]) + sbias[gq + e]);
                sx[buf * M::IN_ROW + o + e] = to_f(rx[o + e]);
                sdt[buf * M::IN_ROW + o + e] = ok ? sp.dt : 0.f;
                if (rev) {
                    const float zf = to_f(rz[o + e]), g = to_f(rgy[o + e]);
                    const float s = sigmoid(zf);
                    sgy[buf * M::IN_ROW + o + e] = g * (zf * s);
                    ssig[o + e] = sp.sig;
                    gzv[e] = from_f<E>(g * to_f(ryp[o + e])
                                       * (s * (1.f + zf * (1.f - s))));
                }
            }
            if (rev) {
                const long long at = gin0 + (long long)t * D;
                if (gate.pairs) {
                    if (gq_live && t < T)
                        *reinterpret_cast<uint32_t*>(gate.gz + at) =
                            *reinterpret_cast<const uint32_t*>(gzv);
                } else {
#pragma unroll
                    for (int e = 0; e < EPW; ++e)
                        if (t < T && gq + e < D - ch0) gate.gz[at + e] = gzv[e];
                }
            }
        }
    };

    // one forward step of this lane's states, rounded as the forward
    // kernel; da_t into `da`
    auto fwd_step = [&](const float* xs, const float* dts, const float* bs,
                        int j, float (&h)[S], float (&da)[S]) {
        const float xt = xs[j * CH + c], dtt = dts[j * CH + c];
        const float dx = __fmul_rn(dtt, xt);
        float bv[S];
        load_states<S>(bs + j * N + l * S, bv);
#pragma unroll
        for (int i = 0; i < S; ++i) {
            da[i] = expf(__fmul_rn(dtt, A[i]));
            h[i] = __fadd_rn(__fmul_rn(da[i], h[i]), __fmul_rn(dx, bv[i]));
        }
    };

    // ---- sweep 1: the state entering every tile -> ckpt ----------------
    {
        float h[S], da[S];
#pragma unroll
        for (int i = 0; i < S; ++i) h[i] = 0.f;
        stage(0, 0, false);
        for (int k = 0; k < tiles; ++k) {
            const int buf = k & 1;
            cp_async_wait<0>();
            if constexpr (GATED) convert(k, buf, false);
            __syncthreads();          // tile k is in, tile k - 1 was read
            if (k + 1 < tiles) stage(k + 1, buf ^ 1, false);
            if (live)
                store_states<S>(ckpt + ((long long)bidx * tiles + k)
                                * ck_tile + ck, h);
            const float* xs = sx + buf * M::IN_ROW;
            const float* dts = sdt + buf * M::IN_ROW;
            const float* bs = sb + buf * M::IN_BC;
#pragma unroll
            for (int j = 0; j < TT; ++j) fwd_step(xs, dts, bs, j, h, da);
        }
    }
    __syncthreads();                  // sweep 1 read its last buffer

    // ---- sweep 2: tiles in reverse ---------------------------------------
    float P[S], gacc[S], hnext[S];
#pragma unroll
    for (int i = 0; i < S; ++i) { P[i] = 0.f; gacc[i] = 0.f; }
    // lane 0's sum of gy_t x_t (gD); the gated form's lane LB/2's sum of
    // the raw projection's gradient (the bias's)
    float lacc = 0.f;
    const long long blk_row = ((long long)blockIdx.x * B + bidx) * T;
    // lane 0 of a channel writes gx_t, lane LB/2 gdt_t
    const bool writes = live && (l & (HALF - 1)) == 0;
    E* const gout = (l == 0 ? gx : gdt) + row0 * D + (writes ? ch : 0);
    const float* ck_seq = ckpt + (long long)bidx * tiles * ck_tile + ck;
    load_states<S>(ck_seq + (long long)(tiles - 1) * ck_tile, hnext);

    stage(tiles - 1, 0, true);
    for (int r = 0; r < tiles; ++r) {
        const int k = tiles - 1 - r;
        const int buf = r & 1;
        float hin[S];
#pragma unroll
        for (int i = 0; i < S; ++i) hin[i] = live ? hnext[i] : 0.f;
        if (k > 0) load_states<S>(ck_seq + (long long)(k - 1) * ck_tile,
                                  hnext);
        cp_async_wait<0>();
        if constexpr (GATED) convert(k, buf, true);
        __syncthreads();    // tile k is in; tile k + 1's walk and sums done
        if (k > 0) stage(k - 1, buf ^ 1, true);
        const int t0 = k * TT;
        const int steps = writes ? T - t0 : 0;      // steps this lane writes
        E* gp = gout + (long long)(t0 + TT - 1) * D;    // at step TT - 1
        const float* xs = sx + buf * M::IN_ROW;
        const float* dts = sdt + buf * M::IN_ROW;
        const float* gys = sgy + buf * M::IN_ROW;
        const float* bs = sb + buf * M::IN_BC;
        const float* cs = sc + buf * M::IN_BC;

        // the tile's states and decays from its checkpoint: da_j for every
        // j and h_j for j < TT - 1 into this thread's shared slots, the last
        // h in registers
        float hc[S];
#pragma unroll
        for (int i = 0; i < S; ++i) hc[i] = hin[i];
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            float da[S];
            fwd_step(xs, dts, bs, j, hc, da);
            store_states<S>(sda + (j * THREADS + tid) * S, da);
            if (j < TT - 1) store_states<S>(sh + (j * THREADS + tid) * S, hc);
        }

        // walk the tile backwards; hc is h_j, hp h_{j-1}
#pragma unroll
        for (int j = TT - 1; j >= 0; --j) {
            const float xt = xs[j * CH + c], dtt = dts[j * CH + c];
            const float gyt = gys[j * CH + c];
            const float dx = __fmul_rn(dtt, xt);
            float bv[S], cv[S], da[S], hp[S], V[2 * S];
            load_states<S>(bs + j * N + l * S, bv);
            load_states<S>(cs + j * N + l * S, cv);
            load_states<S>(sda + (j * THREADS + tid) * S, da);
            if (j > 0) {
                load_states<S>(sh + ((j - 1) * THREADS + tid) * S, hp);
            } else {
#pragma unroll
                for (int i = 0; i < S; ++i) hp[i] = hin[i];
            }
            float gbs = 0.f, gds = 0.f;
#pragma unroll
            for (int i = 0; i < S; ++i) {
                const float G = __fmaf_rn(gyt, cv[i], P[i]);
                gbs = __fmaf_rn(G, bv[i], gbs);
                const float qh = __fmul_rn(__fmul_rn(G, da[i]), hp[i]);
                gacc[i] = __fmaf_rn(dtt, qh, gacc[i]);
                gds = __fmaf_rn(A[i], qh, gds);
                V[i] = __fmul_rn(G, dx);
                V[S + i] = __fmul_rn(gyt, hc[i]);
                P[i] = __fmul_rn(da[i], G);
                hc[i] = hp[i];
            }
            if (l == 0) lacc = __fmaf_rn(gyt, xt, lacc);

            // gx_t, gdt_t: the channel's LB lanes' partials added
            float W[2] = {gbs, __fmaf_rn(xt, gbs, gds)};
            scatter_sum<2, 2, HALF, 1>(W, lane);
            const float gxt = __fmaf_rn(dtt, W[0], __fmul_rn(dsk, gyt));
            if constexpr (GATED) {
                // the raw projection's gradient, and its sum for the bias
                const float graw = __fmul_rn(W[0], ssig[j * CH + c]);
                if (l == HALF) lacc = __fadd_rn(lacc, graw);
                if (j < steps) *gp = from_f<E>(l == 0 ? gxt : graw);
            } else {
                if (j < steps) *gp = l == 0 ? gxt : W[0];
            }
            gp -= D;
            // gB_t, gC_t: summed over the warp's channels, one a lane
            scatter_sum<2 * S, 2 * S, 16, LB>(V, lane);
            swp[(j * WARPS + warp) * 2 * N + wp_at] = V[0];
        }
        __syncthreads();                      // the warps' sums are in
        for (int i = tid; i < TT * 2 * N; i += THREADS) {
            const int j = i / (2 * N), v = i % (2 * N);
            if (t0 + j < T) {
                const float* w = swp + j * WARPS * 2 * N + v;
                float sum = w[0];
#pragma unroll
                for (int q = 1; q < WARPS; ++q)
                    sum = __fadd_rn(sum, w[q * 2 * N]);
                (v < N ? gb_part : gc_part)[(blk_row + t0 + j) * N
                                            + v % N] = sum;
            }
        }
    }
    if (live) {
        store_states<S>(ga_part + ((long long)bidx * D + ch) * N + l * S,
                        gacc);
        if (l == 0) gd_part[(long long)bidx * D + ch] = lacc;
        if constexpr (GATED)
            if (l == HALF) gate.gbias_part[(long long)bidx * D + ch] = lacc;
    }
}

template <typename E>
struct BwdArgs {
    const E *x, *dt;
    const float *a, *b, *c, *d;
    const E* gy;
    E *gx, *gdt;
    float *ga_part, *gb_part, *gc_part, *gd_part, *ckpt;
    BwdGate<E> gate;
    int B, T, D;
};

// the shared-memory attributes of an instance: above 48 KB, and the
// carve-out at its maximum so that two blocks fit an SM
template <int N, bool GATED, typename E>
cudaError_t prepare_bwd() {
    cudaError_t err = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<N, GATED, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        BwdSmem<N, GATED, E>::BYTES);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        selective_scan_bwd_kernel<N, GATED, E>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
}

template <int N, bool GATED, typename E>
cudaError_t launch_bwd(const BwdArgs<E>& p, cudaStream_t s) {
    using M = BwdSmem<N, GATED, E>;
    cudaError_t err = prepare_bwd<N, GATED, E>();
    if (err != cudaSuccess) return err;
    const dim3 grid((p.D + CH - 1) / CH, p.B);
    selective_scan_bwd_kernel<N, GATED, E><<<grid, M::THREADS, M::BYTES,
                                             s>>>(
        p.x, p.dt, p.a, p.b, p.c, p.d, p.gy, p.gx, p.gdt, p.ga_part,
        p.gb_part, p.gc_part, p.gd_part, p.ckpt, p.gate, p.B, p.T, p.D);
    return cudaGetLastError();
}

template <int N, bool GATED, typename E>
cudaError_t occupancy_bwd(int* blocks) {
    using M = BwdSmem<N, GATED, E>;
    cudaError_t err = prepare_bwd<N, GATED, E>();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, selective_scan_bwd_kernel<N, GATED, E>, M::THREADS,
        M::BYTES);
}

template <bool GATED, typename E>
int scan_fwd(const E* x, const E* dt, const float* a, const float* b,
             const float* c, const float* d, E* y, const Gate<E>& g, int B,
             int T, int D, int N, void* stream) {
    if (B <= 0 || T <= 0 || D <= 0) return (int)cudaSuccess;
    if (B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (N) {
        case 4: return (int)launch<4, GATED>(x, dt, a, b, c, d, y, g, B, T, D,
                                             s);
        case 8: return (int)launch<8, GATED>(x, dt, a, b, c, d, y, g, B, T, D,
                                             s);
        case 16: return (int)launch<16, GATED>(x, dt, a, b, c, d, y, g, B, T,
                                               D, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool GATED, typename E>
int scan_bwd(const BwdArgs<E>& p, int N, void* stream) {
    if (p.B <= 0 || p.T <= 0 || p.D <= 0) return (int)cudaSuccess;
    if (p.B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (N) {
        case 4: return (int)launch_bwd<4, GATED>(p, s);
        case 8: return (int)launch_bwd<8, GATED>(p, s);
        case 16: return (int)launch_bwd<16, GATED>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool GATED, typename E>
int occupancy(int N, int* blocks) {
    switch (N) {
        case 4: return (int)occupancy_bwd<4, GATED, E>(blocks);
        case 8: return (int)occupancy_bwd<8, GATED, E>(blocks);
        case 16: return (int)occupancy_bwd<16, GATED, E>(blocks);
        default: return (int)cudaErrorInvalidValue;
    }
}

// the gated backward's arguments for element type E
template <typename E>
int gated_bwd(const void* x, const void* dt_raw, const void* dt_bias,
              const void* z, long long z_sb, long long z_st,
              const void* y_pre, const float* a, const float* b,
              const float* c, const float* d, const void* g, void* gx,
              void* g_raw, void* gz, float* ga_part, float* gb_part,
              float* gc_part, float* gd_part, float* gbias_part, float* ckpt,
              int B, int T, int D, int N, void* stream) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(x)
        | reinterpret_cast<uintptr_t>(dt_raw) | reinterpret_cast<uintptr_t>(z)
        | reinterpret_cast<uintptr_t>(y_pre) | reinterpret_cast<uintptr_t>(g)
        | reinterpret_cast<uintptr_t>(gz);
    const bool pairs = sizeof(E) == 4
        || (D % 2 == 0 && addr % 4 == 0 && z_sb % 2 == 0 && z_st % 2 == 0);
    const BwdArgs<E> p{
        static_cast<const E*>(x), static_cast<const E*>(dt_raw), a, b, c, d,
        static_cast<const E*>(g), static_cast<E*>(gx), static_cast<E*>(g_raw),
        ga_part, gb_part, gc_part, gd_part, ckpt,
        BwdGate<E>{static_cast<const E*>(dt_bias), static_cast<const E*>(z),
                   z_sb, z_st, static_cast<const E*>(y_pre),
                   static_cast<E*>(gz), gbias_part, (int)pairs},
        B, T, D};
    return scan_bwd<true, E>(p, N, stream);
}

}  // namespace

// All float32, contiguous: x, dt, y (B, T, D); a (D, N); b, c (B, T, N);
// d (D,). N in {4, 8, 16}.
extern "C" int selective_scan(const float* x, const float* dt, const float* a,
                              const float* b, const float* c, const float* d,
                              float* y, int B, int T, int D, int N,
                              void* stream) {
    return scan_fwd<false, float>(x, dt, a, b, c, d, y, Gate<float>{}, B, T,
                                  D, N, stream);
}

// The gated forward: y = scan(x, softplus(dt_raw + dt_bias), a, b, c, d) *
// silu(z) and, where y_pre is not null, the scan's output before the gate.
// x, dt_raw, y, y_pre (B, T, D) contiguous, dt_bias (D,), z (B, T, D) at
// strides (z_sb, z_st, 1), all bf16 (bf16 != 0) or all float32; a, b, c, d
// float32 as for `selective_scan`. N in {4, 8, 16}.
extern "C" int selective_scan_gated(const void* x, const void* dt_raw,
                                    const void* dt_bias, const void* z,
                                    long long z_sb, long long z_st,
                                    const float* a, const float* b,
                                    const float* c, const float* d, void* y,
                                    void* y_pre, int B, int T, int D, int N,
                                    int bf16, void* stream) {
    if (bf16) {
        using E = __nv_bfloat16;
        const Gate<E> g{static_cast<const E*>(dt_bias),
                        static_cast<const E*>(z), z_sb, z_st,
                        static_cast<E*>(y_pre)};
        return scan_fwd<true, E>(static_cast<const E*>(x),
                                 static_cast<const E*>(dt_raw), a, b, c, d,
                                 static_cast<E*>(y), g, B, T, D, N, stream);
    }
    const Gate<float> g{static_cast<const float*>(dt_bias),
                        static_cast<const float*>(z), z_sb, z_st,
                        static_cast<float*>(y_pre)};
    return scan_fwd<true, float>(static_cast<const float*>(x),
                                 static_cast<const float*>(dt_raw), a, b, c,
                                 d, static_cast<float*>(y), g, B, T, D, N,
                                 stream);
}

// The backward, all float32, contiguous: x, dt, gy, gx, gdt (B, T, D);
// a (D, N); b, c (B, T, N); d (D,); partial sums ga_part (B, D, N),
// gd_part (B, D), gb_part and gc_part (ceil(D / 32), B, T, N); scratch
// ckpt (B, ceil(T / 16), D, N). N in {4, 8, 16}.
extern "C" int selective_scan_bwd(const float* x, const float* dt,
                                  const float* a, const float* b,
                                  const float* c, const float* d,
                                  const float* gy, float* gx, float* gdt,
                                  float* ga_part, float* gb_part,
                                  float* gc_part, float* gd_part,
                                  float* ckpt, int B, int T, int D, int N,
                                  void* stream) {
    const BwdArgs<float> p{x, dt, a, b, c, d, gy, gx, gdt, ga_part, gb_part,
                           gc_part, gd_part, ckpt, BwdGate<float>{}, B, T, D};
    return scan_bwd<false, float>(p, N, stream);
}

// The gated backward for the upstream gradient g of the gated forward's y:
// gx, g_raw (dt_raw's gradient) and gz (z's, (B, T, D) contiguous) of x's
// type; the partial sums of `selective_scan_bwd` and gbias_part (B, D), the
// sequences' sums of g_raw, float32. The operands as the gated forward
// takes them, y_pre its output before the gate and g (B, T, D) contiguous.
extern "C" int selective_scan_gated_bwd(
    const void* x, const void* dt_raw, const void* dt_bias, const void* z,
    long long z_sb, long long z_st, const void* y_pre, const float* a,
    const float* b, const float* c, const float* d, const void* g, void* gx,
    void* g_raw, void* gz, float* ga_part, float* gb_part, float* gc_part,
    float* gd_part, float* gbias_part, float* ckpt, int B, int T, int D,
    int N, int bf16, void* stream) {
    if (bf16)
        return gated_bwd<__nv_bfloat16>(
            x, dt_raw, dt_bias, z, z_sb, z_st, y_pre, a, b, c, d, g, gx,
            g_raw, gz, ga_part, gb_part, gc_part, gd_part, gbias_part, ckpt,
            B, T, D, N, stream);
    return gated_bwd<float>(
        x, dt_raw, dt_bias, z, z_sb, z_st, y_pre, a, b, c, d, g, gx, g_raw,
        gz, ga_part, gb_part, gc_part, gd_part, gbias_part, ckpt, B, T, D, N,
        stream);
}

// The occupancy API's resident blocks an SM of the backward's instance for
// d_state N, plain (gated 0) or gated in bf16 or float32, into *blocks.
extern "C" int selective_scan_bwd_occupancy(int N, int gated, int bf16,
                                            int* blocks) {
    if (!gated) return occupancy<false, float>(N, blocks);
    return bf16 ? occupancy<true, __nv_bfloat16>(N, blocks)
                : occupancy<true, float>(N, blocks);
}
