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
// What bounds it on an H100: as the forward, the instruction issue and the
// exponentials, not the bytes (x, dt, gy read and gx, gdt written: 20 B per
// (t, channel)). The least work is twice the forward's exponentials (da_t
// once for h, once for G); this design pays three (see below).
//
// Design (simple first; a faster one is queued in ROADMAP.md):
// - The forward's layout: a block holds CH = 32 channels of one sequence,
//   each channel's N states split across L = 2 lanes (S = N / 2 a lane),
//   tiles of TT = 16 steps staged in shared memory with `cp.async`
//   (4-byte copies, double-buffered, zero past T and D: a zero step leaves
//   h as it is and adds nothing to any gradient).
// - Sweep 1 re-runs the recurrence, rounded as the forward rounds it, and
//   stores the state entering every tile in `ckpt` (B, ceil(T/TT), D, N).
// - Sweep 2 walks the tiles backwards: it recomputes the tile's TT states
//   from its checkpoint into shared memory (each thread's own slots), then
//   walks the tile backwards carrying da_{t+1} * G_{t+1} in registers.
//   gx_t and gdt_t: each lane's sum over its states, the two lanes' added
//   by `__shfl_xor_sync`. gA and gD: each thread's sum over t, written per
//   sequence (`ga_part` (B, D, N), `gd_part` (B, D)). gB_t and gC_t: the
//   sums over a warp's 16 channels by an xor butterfly, the block's two
//   warps added in shared memory, one row per block (`gb_part`,
//   `gc_part` (n_blocks, B, T, N)).
// - No float atomics: every sum has a fixed order, and the wrapper adds
//   the partials with `torch.sum` over their leading axis, so two
//   identical calls give identical bits.

constexpr int BWD_THREADS = CH * L;
constexpr int BWD_WARPS = BWD_THREADS / 32;

// dynamic shared memory of the backward kernel, in floats
template <int N>
struct BwdSmem {
    static constexpr int S = N / L;
    static constexpr int IN_ROW = TT * CH;      // x, dt, gy: a tile
    static constexpr int IN_BC = TT * N;        // B_t, C_t: a tile
    static constexpr int X = 0;
    static constexpr int DT = X + 2 * IN_ROW;
    static constexpr int GY = DT + 2 * IN_ROW;
    static constexpr int BB = GY + 2 * IN_ROW;
    static constexpr int CC = BB + 2 * IN_BC;
    static constexpr int H = CC + 2 * IN_BC;    // [TT][S][BWD_THREADS]
    static constexpr int WB = H + TT * S * BWD_THREADS;   // [warps][TT][N]
    static constexpr int WC = WB + BWD_WARPS * TT * N;
    static constexpr int FLOATS = WC + BWD_WARPS * TT * N;
    static constexpr int BYTES = FLOATS * 4;
};

template <int N>
__global__ void __launch_bounds__(CH * L)
selective_scan_bwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ dskip,
                          const float* __restrict__ gy,
                          float* __restrict__ gx, float* __restrict__ gdt,
                          float* __restrict__ ga_part,
                          float* __restrict__ gb_part,
                          float* __restrict__ gc_part,
                          float* __restrict__ gd_part,
                          float* __restrict__ ckpt, int B, int T, int D) {
    using M = BwdSmem<N>;
    constexpr int S = M::S;
    extern __shared__ __align__(16) float smem[];
    float* sx = smem + M::X;
    float* sdt = smem + M::DT;
    float* sgy = smem + M::GY;
    float* sb = smem + M::BB;
    float* sc = smem + M::CC;
    float* sh = smem + M::H;
    float* swb = smem + M::WB;
    float* swc = smem + M::WC;

    const int tid = threadIdx.x;
    const int c = tid / L, l = tid % L;
    const int warp = tid / 32;
    const int ch0 = blockIdx.x * CH;
    const int ch = ch0 + c;
    const bool live = ch < D;
    const int bidx = blockIdx.y;
    const long long row0 = (long long)bidx * T;
    const int tiles = (T + TT - 1) / TT;

    float A[S];
#pragma unroll
    for (int i = 0; i < S; ++i)
        A[i] = live ? a[(long long)ch * N + l * S + i] : 0.f;
    const float dsk = live ? dskip[ch] : 0.f;

    // tile k into buffer `buf`: x, dt and B_t always, gy and C_t for the
    // reverse sweep; zero past T and D
    auto stage = [&](int k, int buf, bool rev) {
        const int t0 = k * TT;
        for (int i = tid; i < TT * CH; i += BWD_THREADS) {
            const int j = i / CH, q = i % CH;
            const bool ok = t0 + j < T && ch0 + q < D;
            const long long at = ok ? (row0 + t0 + j) * D + ch0 + q : 0;
            const int o = buf * M::IN_ROW + i;
            cp_async<4>(sx + o, x + at, ok);
            cp_async<4>(sdt + o, dt + at, ok);
            if (rev) cp_async<4>(sgy + o, gy + at, ok);
        }
        const int nb = min(TT, T - t0) * N;
        for (int i = tid; i < TT * N; i += BWD_THREADS) {
            const bool ok = i < nb;
            const long long at = ok ? (row0 + t0) * N + i : 0;
            const int o = buf * M::IN_BC + i;
            cp_async<4>(sb + o, bm + at, ok);
            if (rev) cp_async<4>(sc + o, cm + at, ok);
        }
        cp_async_commit();
    };

    // one forward step of this lane's states, rounded as the forward kernel
    auto fwd_step = [&](const float* xs, const float* dts, const float* bs,
                        int j, float (&h)[S]) {
        const float xt = xs[j * CH + c], dtt = dts[j * CH + c];
        const float dx = __fmul_rn(dtt, xt);
        float bv[S];
        load_states<S>(bs + j * N + l * S, bv);
#pragma unroll
        for (int i = 0; i < S; ++i) {
            const float da = expf(__fmul_rn(dtt, A[i]));
            h[i] = __fadd_rn(__fmul_rn(da, h[i]), __fmul_rn(dx, bv[i]));
        }
    };

    // ---- sweep 1: the state entering every tile -> ckpt ----------------
    {
        float h[S];
#pragma unroll
        for (int i = 0; i < S; ++i) h[i] = 0.f;
        stage(0, 0, false);
        for (int k = 0; k < tiles; ++k) {
            const int buf = k & 1;
            if (k + 1 < tiles) {
                stage(k + 1, buf ^ 1, false);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            if (live) {
                float* dst = ckpt + (((long long)bidx * tiles + k) * D + ch)
                                        * N + l * S;
#pragma unroll
                for (int i = 0; i < S; ++i) dst[i] = h[i];
            }
            const float* xs = sx + buf * M::IN_ROW;
            const float* dts = sdt + buf * M::IN_ROW;
            const float* bs = sb + buf * M::IN_BC;
#pragma unroll
            for (int j = 0; j < TT; ++j) fwd_step(xs, dts, bs, j, h);
            __syncthreads();                  // buffer `buf` is free
        }
    }

    // ---- sweep 2: tiles in reverse ---------------------------------------
    float P[S], gacc[S];
#pragma unroll
    for (int i = 0; i < S; ++i) { P[i] = 0.f; gacc[i] = 0.f; }
    float gdacc = 0.f;
    const long long blk_row = ((long long)blockIdx.x * B + bidx) * T;

    stage(tiles - 1, 0, true);
    for (int r = 0; r < tiles; ++r) {
        const int k = tiles - 1 - r;
        const int buf = r & 1;
        if (k > 0) {
            stage(k - 1, buf ^ 1, true);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                      // tile k has landed
        const int t0 = k * TT;
        const float* xs = sx + buf * M::IN_ROW;
        const float* dts = sdt + buf * M::IN_ROW;
        const float* gys = sgy + buf * M::IN_ROW;
        const float* bs = sb + buf * M::IN_BC;
        const float* cs = sc + buf * M::IN_BC;

        // the tile's states from its checkpoint: h_j for j < TT - 1 into
        // this thread's shared slots, the last in registers
        float hin[S], hlast[S];
        {
            const float* src = ckpt + (((long long)bidx * tiles + k) * D
                                       + (live ? ch : 0)) * N + l * S;
#pragma unroll
            for (int i = 0; i < S; ++i) {
                hin[i] = live ? src[i] : 0.f;
                hlast[i] = hin[i];
            }
        }
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            fwd_step(xs, dts, bs, j, hlast);
            if (j < TT - 1) {
#pragma unroll
                for (int i = 0; i < S; ++i)
                    sh[(j * S + i) * BWD_THREADS + tid] = hlast[i];
            }
        }

        // walk the tile backwards
#pragma unroll
        for (int j = TT - 1; j >= 0; --j) {
            const float xt = xs[j * CH + c], dtt = dts[j * CH + c];
            const float gyt = gys[j * CH + c];
            const float dx = __fmul_rn(dtt, xt);
            float bv[S], cv[S], vb[S], vc[S];
            load_states<S>(bs + j * N + l * S, bv);
            load_states<S>(cs + j * N + l * S, cv);
            float sgb = 0.f, sgdt = 0.f;
#pragma unroll
            for (int i = 0; i < S; ++i) {
                const float hc = j == TT - 1
                    ? hlast[i] : sh[(j * S + i) * BWD_THREADS + tid];
                const float hp = j == 0
                    ? hin[i] : sh[((j - 1) * S + i) * BWD_THREADS + tid];
                const float da = expf(__fmul_rn(dtt, A[i]));
                const float G = __fadd_rn(__fmul_rn(gyt, cv[i]), P[i]);
                sgb = __fadd_rn(sgb, __fmul_rn(G, bv[i]));
                const float in = __fadd_rn(
                    __fmul_rn(__fmul_rn(A[i], da), hp), __fmul_rn(xt, bv[i]));
                sgdt = __fadd_rn(sgdt, __fmul_rn(G, in));
                gacc[i] = __fadd_rn(
                    gacc[i], __fmul_rn(__fmul_rn(__fmul_rn(G, dtt), da), hp));
                vb[i] = __fmul_rn(G, dx);
                vc[i] = __fmul_rn(gyt, hc);
                P[i] = __fmul_rn(da, G);
            }
            gdacc = __fadd_rn(gdacc, __fmul_rn(gyt, xt));
#pragma unroll
            for (int o = 1; o < L; o <<= 1) {
                sgb = __fadd_rn(sgb, __shfl_xor_sync(0xffffffffu, sgb, o));
                sgdt = __fadd_rn(sgdt, __shfl_xor_sync(0xffffffffu, sgdt, o));
            }
            const int t = t0 + j;
            if (l == 0 && live && t < T) {
                const long long at = (row0 + t) * D + ch;
                gx[at] = __fadd_rn(__fmul_rn(dsk, gyt), __fmul_rn(dtt, sgb));
                gdt[at] = sgdt;
            }
            // sums over the warp's 16 channels (lane bits 1..4)
#pragma unroll
            for (int i = 0; i < S; ++i) {
#pragma unroll
                for (int o = L; o < 32; o <<= 1) {
                    vb[i] = __fadd_rn(vb[i],
                                      __shfl_xor_sync(0xffffffffu, vb[i], o));
                    vc[i] = __fadd_rn(vc[i],
                                      __shfl_xor_sync(0xffffffffu, vc[i], o));
                }
            }
            if ((tid & 31) < L) {
#pragma unroll
                for (int i = 0; i < S; ++i) {
                    swb[(warp * TT + j) * N + l * S + i] = vb[i];
                    swc[(warp * TT + j) * N + l * S + i] = vc[i];
                }
            }
        }
        __syncthreads();                      // the warps' sums are in
        for (int i = tid; i < TT * N; i += BWD_THREADS) {
            const int j = i / N, n = i % N;
            if (t0 + j < T) {
                float vbs = swb[j * N + n], vcs = swc[j * N + n];
#pragma unroll
                for (int w = 1; w < BWD_WARPS; ++w) {
                    vbs = __fadd_rn(vbs, swb[(w * TT + j) * N + n]);
                    vcs = __fadd_rn(vcs, swc[(w * TT + j) * N + n]);
                }
                gb_part[(blk_row + t0 + j) * N + n] = vbs;
                gc_part[(blk_row + t0 + j) * N + n] = vcs;
            }
        }
        __syncthreads();           // buffer `buf` and the warp sums are free
    }
    if (live) {
        float* dst = ga_part + ((long long)bidx * D + ch) * N + l * S;
#pragma unroll
        for (int i = 0; i < S; ++i) dst[i] = gacc[i];
        if (l == 0) gd_part[(long long)bidx * D + ch] = gdacc;
    }
}

template <int N>
cudaError_t launch_bwd(const float* x, const float* dt, const float* a,
                       const float* bm, const float* cm, const float* dskip,
                       const float* gy, float* gx, float* gdt, float* ga_part,
                       float* gb_part, float* gc_part, float* gd_part,
                       float* ckpt, int B, int T, int D, cudaStream_t s) {
    constexpr int bytes = BwdSmem<N>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        selective_scan_bwd_kernel<N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((D + CH - 1) / CH, B);
    selective_scan_bwd_kernel<N><<<grid, BWD_THREADS, bytes, s>>>(
        x, dt, a, bm, cm, dskip, gy, gx, gdt, ga_part, gb_part, gc_part,
        gd_part, ckpt, B, T, D);
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
    if (B <= 0 || T <= 0 || D <= 0) return (int)cudaSuccess;
    if (B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (N) {
        case 4: return (int)launch_bwd<4>(x, dt, a, b, c, d, gy, gx, gdt,
                                          ga_part, gb_part, gc_part, gd_part,
                                          ckpt, B, T, D, s);
        case 8: return (int)launch_bwd<8>(x, dt, a, b, c, d, gy, gx, gdt,
                                          ga_part, gb_part, gc_part, gd_part,
                                          ckpt, B, T, D, s);
        case 16: return (int)launch_bwd<16>(x, dt, a, b, c, d, gy, gx, gdt,
                                            ga_part, gb_part, gc_part,
                                            gd_part, ckpt, B, T, D, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
