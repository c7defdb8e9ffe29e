// Selective state-space scan (Mamba-1), the prefill recurrence.
//
// Replaces the TPU kernel `_scan_kernel` / `selective_scan_kernel`
// (kernels/selective_scan/selective_scan.py of the JAX package): for x, dt
// (B, T, D), A (D, N), B_t, C_t (B, T, N) and the skip D (D,), all float32,
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      (per channel)
//     y_t = <h_t, C_t> + D * x_t
// with h_0 = 0, returning y (B, T, D).
//
// What bounds it on an H100: bytes (x and dt read, y written: 12 B per
// (t, channel); B_t and C_t are shared by every channel) and the B * T * D
// * N exponentials; which of the two is larger depends on N. The time axis
// is a true recurrence, so the design gives each thread one (sequence,
// channel) with its N-wide state in registers for the whole sequence, and
// the time loop runs inside the thread - the state never touches device
// memory, as the TPU kernel keeps it in VMEM. A block holds THREADS
// neighbouring channels of one sequence and walks T in tiles of TT steps:
// the block stages the tile's x and dt (coalesced: one row of THREADS
// floats per step) and its B_t and C_t rows (shared by all its channels)
// in shared memory, then every thread runs the TT steps out of shared
// memory and writes y_t (coalesced). Blocks are independent: there is no
// carry between them, where the TPU grid walked time blocks in order with
// the state in scratch. Any T (the last tile is short) and any D (threads
// past D only help stage), no padding; N in {4, 8, 16} (a template: the
// state must stay in registers). `expf`, not the fast intrinsic, and the
// state update rounded as the plain version's separate multiplies and add
// (an FMA there drifts from it over thousands of steps: 1e-4 at T = 2048);
// y's sum over N takes another order (3e-5 against the plain version).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int TT = 32;        // time steps staged per tile

template <int N>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ dskip, float* __restrict__ y,
                      int T, int D) {
    __shared__ float sx[TT][THREADS], sdt[TT][THREADS];
    __shared__ float sb[TT * N], sc[TT * N];
    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int ch = blockIdx.x * THREADS + tid;
    const bool live = ch < D;

    float A[N], h[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
        A[n] = live ? a[(long long)ch * N + n] : 0.f;
        h[n] = 0.f;
    }
    const float dsk = live ? dskip[ch] : 0.f;
    const long long row0 = (long long)b * T;       // (b, t = 0)

    for (int t0 = 0; t0 < T; t0 += TT) {
        const int nt = min(TT, T - t0);
        __syncthreads();                           // last tile consumed
        if (live) {
            for (int j = 0; j < nt; ++j) {
                const long long at = (row0 + t0 + j) * D + ch;
                sx[j][tid] = x[at];
                sdt[j][tid] = dt[at];
            }
        }
        const long long nb = (row0 + t0) * N;
        for (int i = tid; i < nt * N; i += THREADS) {
            sb[i] = bm[nb + i];
            sc[i] = cm[nb + i];
        }
        __syncthreads();
        if (!live) continue;
        for (int j = 0; j < nt; ++j) {
            const float xt = sx[j][tid], dtt = sdt[j][tid];
            const float dx = dtt * xt;
            float yt = 0.f;
#pragma unroll
            for (int n = 0; n < N; ++n) {
                const float da = expf(dtt * A[n]);
                // rounded as the plain version rounds it (no contraction
                // into an FMA): the state carries its rounding through
                // every later step, so it stays equal to the plain one's
                h[n] = __fadd_rn(__fmul_rn(da, h[n]),
                                 __fmul_rn(dx, sb[j * N + n]));
                yt += h[n] * sc[j * N + n];
            }
            y[(row0 + t0 + j) * D + ch] = yt + dsk * xt;
        }
    }
}

template <int N>
cudaError_t launch(const float* x, const float* dt, const float* a,
                   const float* bm, const float* cm, const float* dskip,
                   float* y, int B, int T, int D, cudaStream_t s) {
    const dim3 grid((D + THREADS - 1) / THREADS, B);
    selective_scan_kernel<N><<<grid, THREADS, 0, s>>>(x, dt, a, bm, cm, dskip,
                                                      y, T, D);
    return cudaGetLastError();
}

}  // namespace

// All float32, contiguous: x, dt, y (B, T, D); a (D, N); b, c (B, T, N);
// d (D,).
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
