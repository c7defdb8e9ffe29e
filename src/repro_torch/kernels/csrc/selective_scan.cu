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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int N, bool VEC>
__global__ void __launch_bounds__(CH * L)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ dskip, float* __restrict__ y,
                      int T, int D) {
    constexpr int S = N / L;                       // states a lane
    constexpr int THREADS = CH * L;
    __shared__ __align__(16) float sx[2][TT][CH];
    __shared__ __align__(16) float sdt[2][TT][CH];
    __shared__ __align__(16) float sb[2][TT * N];
    __shared__ __align__(16) float sc[2][TT * N];
    __shared__ __align__(16) float sy[TT][CH];

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

    // tile k's x, dt, B_t, C_t into buffer `buf`, zero past T and D
    auto stage = [&](int k, int buf) {
        const int t0 = k * TT;
        if constexpr (VEC) {
            constexpr int Q = CH / 4;              // 16-byte chunks a row
            for (int i = tid; i < TT * Q; i += THREADS) {
                const int j = i / Q, q = (i % Q) * 4;
                const bool ok = t0 + j < T && ch0 + q < D;
                const long long at = ok ? (row0 + t0 + j) * D + ch0 + q : 0;
                cp_async<16>(&sx[buf][j][q], x + at, ok);
                cp_async<16>(&sdt[buf][j][q], dt + at, ok);
            }
            const int nb = min(TT, T - t0) * N;    // valid floats of B_t
            for (int i = tid * 4; i < TT * N; i += THREADS * 4) {
                const bool ok = i < nb;
                const long long at = ok ? (row0 + t0) * N + i : 0;
                cp_async<16>(&sb[buf][i], bm + at, ok);
                cp_async<16>(&sc[buf][i], cm + at, ok);
            }
        } else {
            for (int i = tid; i < TT * CH; i += THREADS) {
                const int j = i / CH, q = i % CH;
                const bool ok = t0 + j < T && ch0 + q < D;
                const long long at = ok ? (row0 + t0 + j) * D + ch0 + q : 0;
                cp_async<4>(&sx[buf][j][q], x + at, ok);
                cp_async<4>(&sdt[buf][j][q], dt + at, ok);
            }
            const int nb = min(TT, T - t0) * N;
            for (int i = tid; i < TT * N; i += THREADS) {
                const bool ok = i < nb;
                const long long at = ok ? (row0 + t0) * N + i : 0;
                cp_async<4>(&sb[buf][i], bm + at, ok);
                cp_async<4>(&sc[buf][i], cm + at, ok);
            }
        }
        cp_async_commit();
    };

    const int tiles = (T + TT - 1) / TT;
    stage(0, 0);
    for (int k = 0; k < tiles; ++k) {
        const int buf = k & 1;
        if (k + 1 < tiles) {
            stage(k + 1, buf ^ 1);     // read last in tile k - 1: synced
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                           // tile k has landed
        const int t0 = k * TT;
        const float* bt = sb[buf] + l * S;
        const float* ct = sc[buf] + l * S;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            const float xt = sx[buf][j][c], dtt = sdt[buf][j][c];
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
        if constexpr (VEC) {
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

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* bm, const float* cm, const float* dskip,
                   float* y, int B, int T, int D, cudaStream_t s) {
    const dim3 grid((D + CH - 1) / CH, B);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(x)
        | reinterpret_cast<uintptr_t>(dt) | reinterpret_cast<uintptr_t>(bm)
        | reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(y);
    if (D % 4 == 0 && addr % 16 == 0)
        selective_scan_kernel<N, true><<<grid, CH * L, 0, s>>>(
            x, dt, a, bm, cm, dskip, y, T, D);
    else
        selective_scan_kernel<N, false><<<grid, CH * L, 0, s>>>(
            x, dt, a, bm, cm, dskip, y, T, D);
    return cudaGetLastError();
}

}  // namespace

// All float32, contiguous: x, dt, y (B, T, D); a (D, N); b, c (B, T, N);
// d (D,). N in {4, 8, 16}.
extern "C" int selective_scan(const float* x, const float* dt, const float* a,
                              const float* b, const float* c, const float* d,
                              float* y, int B, int T, int D, int N,
                              void* stream) {
    if (B <= 0 || T <= 0 || D <= 0) return (int)cudaSuccess;
    if (B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (N) {
        case 4: return (int)launch<4>(x, dt, a, b, c, d, y, B, T, D, s);
        case 8: return (int)launch<8>(x, dt, a, b, c, d, y, B, T, D, s);
        case 16: return (int)launch<16>(x, dt, a, b, c, d, y, B, T, D, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
